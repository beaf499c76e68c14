"""The 4-shard MoE dispatch and `embed_skew_aware` cases of
`tests/test_torch_spmd.py`, without JAX: the cases, their run on a port
mesh, and the gloo worker that runs them one machine a rank (spawned
processes import this module, not the JAX one). Here: the stacked mesh
against one device.
"""
import numpy as np
import torch

from repro_torch.core import spmd
from repro_torch.core.embedding import EmbedCache, embed_skew_aware
from repro_torch.core.shardexec import StackedMesh, everywhere

torch.set_num_threads(1)

P = 4


def mesh_inputs():
    """tests/test_spmd.py's 4-way workload, plus an embedding case."""
    rng = np.random.default_rng(1)
    T, d, f, E, k = 128, 16, 32, 8, 2
    x = rng.normal(size=(T, d)).astype(np.float32)
    w_in = (rng.normal(size=(E, d, 2 * f)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(E, f, d)) * 0.1).astype(np.float32)
    logits = rng.normal(size=(T, E))
    logits[:, 5] += 4.0
    top = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    gates = np.full((T, k), 0.5, dtype=np.float32)
    V, ed = 50, 8
    table = rng.normal(size=(V, ed)).astype(np.float32)
    ids = (rng.zipf(1.3, (P, 32)) % V).astype(np.int32)
    hot = np.array([0, 1, 2], dtype=np.int32)
    lookup = np.full(V, -1, dtype=np.int32)
    lookup[hot] = np.arange(3)
    counts = rng.integers(0, 5, V).astype(np.int32)
    return dict(x=x, w_in=w_in, w_out=w_out, top=top, gates=gates,
                table=table, ids=ids, hot=hot, lookup=lookup, counts=counts)


# (name, capacity_factor, num_hot): push-pull at ample and tight capacity,
# direct push (drops), direct pull
MESH_CASES = [("moe_push_pull", 4.0, 2), ("moe_push_pull", 0.6, 2),
              ("moe_direct_push", 0.6, 0), ("moe_direct_pull", 1.25, 0)]


def run_port_mesh(mesh):
    """The MESH_CASES and the embedding case on a port mesh; returns a dict
    of numpy arrays (every shard's rows, in shard order)."""
    inp = mesh_inputs()
    rows = mesh.shards
    E = inp["w_in"].shape[0]

    def sh(a):  # this process's shards of an array split on its first axis
        return torch.from_numpy(a.reshape((P, -1) + a.shape[1:])[rows]
                                .copy())

    out = {}
    for i, (name, cf, hot) in enumerate(MESH_CASES):
        cfg = spmd.MoEDispatchConfig(num_experts=E, top_k=2,
                                     capacity_factor=cf, num_hot=hot,
                                     mesh=mesh)
        y, aux = getattr(spmd, name)(sh(inp["x"]), sh(inp["top"]),
                                     sh(inp["gates"]), sh(inp["w_in"]),
                                     sh(inp["w_out"]), cfg)
        out[f"y{i}"] = everywhere(mesh, y).reshape(-1, y.shape[-1]).numpy()
        out[f"dropped{i}"] = everywhere(mesh, aux.dropped_assignments)
        out[f"counts{i}"] = everywhere(mesh, aux.expert_counts).numpy()
    cache = EmbedCache(
        hot_ids=torch.from_numpy(inp["hot"]),
        hot_rows=torch.from_numpy(inp["table"][inp["hot"]]),
        lookup=torch.from_numpy(inp["lookup"]),
        counts=torch.from_numpy(inp["counts"]))
    emb, c2, hit = embed_skew_aware(torch.from_numpy(inp["table"]),
                                    sh(inp["ids"].reshape(-1)), cache, mesh)
    out["emb"] = everywhere(mesh, emb).reshape(-1, emb.shape[-1]).numpy()
    out["emb_counts"] = c2.counts.numpy()
    out["hit"] = everywhere(mesh, hit).numpy()
    out["dropped"] = np.array([np.asarray(out.pop(f"dropped{i}"))
                               for i in range(len(MESH_CASES))])
    return out


def _group_worker(rank, world, port, out_path):
    import torch.distributed as dist

    from repro_torch.core.shardexec import get_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = get_mesh(P, "cpu")
        out = run_port_mesh(mesh)
        if rank == 0:
            np.savez(out_path, kind=mesh.kind, **out)
    finally:
        dist.destroy_process_group()





def test_stacked_mesh_with_ample_capacity_is_the_dense_oracle():
    got = run_port_mesh(StackedMesh(P, "cpu"))
    inp = mesh_inputs()
    ref = spmd.moe_reference(*(torch.from_numpy(inp[k]) for k in
                               ("x", "top", "gates", "w_in", "w_out")))
    np.testing.assert_allclose(got["y0"], ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["y3"], ref.numpy(), atol=1e-5)
    assert got["dropped"][0].max() == got["dropped"][3].max() == 0
    want = np.bincount(inp["top"].ravel(), minlength=8)
    for i in range(len(MESH_CASES)):
        assert (got[f"counts{i}"] == want).all()


def test_no_mesh_is_a_one_shard_mesh():
    """`mesh=None` runs the body on a stacked mesh of one shard: passing
    that mesh explicitly gives the same bits."""
    inp = mesh_inputs()
    args = [torch.from_numpy(inp[k]) for k in
            ("x", "top", "gates", "w_in", "w_out")]
    for name, cf, hot in MESH_CASES:
        cfg = spmd.MoEDispatchConfig(num_experts=8, top_k=2,
                                     capacity_factor=cf, num_hot=hot)
        y, aux = getattr(spmd, name)(*args, cfg)
        one = spmd.MoEDispatchConfig(num_experts=8, top_k=2,
                                     capacity_factor=cf, num_hot=hot,
                                     mesh=StackedMesh(1, "cpu"))
        y1, aux1 = getattr(spmd, name)(*(a[None] for a in args), one)
        assert torch.equal(y, y1[0])
        assert int(aux.dropped_assignments) == int(aux1.dropped_assignments)
