"""The LM, the port of the JAX package's `models/model.py` for its five
patterns (dense, parallel, moe, zamba2, xlstm): init, forward, prefill,
decode and the decode caches, with a Python loop over the layers (no
scan).

`Model(cfg, device=None, seed=0, mesh=None)` builds its parameters on
`device` (CUDA when None: it raises without a card; the tests pass "cpu")
from a seeded `torch.Generator`; on the meta device it builds them with no
generator and no storage (the shapes alone, as `jax.eval_shape` gives the
JAX package). `from_jax_params` carries a JAX `Model.init` pytree across
(the layouts are the JAX package's, so it only renames).

`mesh` (`launch.mesh.Mesh`) is the model-level mesh: a MoE config's
expert tables pad to a multiple of its "model" axis (the padded experts
are masked in the router), and the MoE layers run the JAX package's mesh
branches on it (`models/moe.py`). Everything else runs on the whole batch
on the one device. The JAX package's residual-stream sharding constraint
(`act_sharding`, `with_sharding_constraint` at every block) places
tensors across devices under GSPMD and has no counterpart in one process.

Caches keep the JAX package's structure and stacking: (k, v) of (L, B, T,
KV, hd) for the dense, parallel and moe patterns; for zamba2 {"mamba":
MambaState(conv (L, B, d_conv-1, C), ssm (L, B, nh, hd, ds) float32),
"attn": (k, v) of (n_apps, B, T, KV, hd)}; for xlstm {"mlstm":
(MLSTMState(C (U, M, B, H, hd, hd), n (U, M, B, H, hd), m (U, M, B, H)),
conv tail (U, M, B, 3, d_up)), "slstm": SLSTMState(c, n, m, h each (U, B,
d))} over U units of M = slstm_every - 1 mLSTM layers and one sLSTM layer,
the states in float32. `cache[i]` is a contiguous layer, as the decode
kernel takes it. Where the JAX package returns updated copies, the port
writes the caches in place: `prefill` fills buffers from `init_caches`
layer by layer and `decode_step` writes slot `cache_pos` (the recurrent
states: the layer's new state).

`forward`, `prefill` and `decode_step` serve: they run under
`torch.no_grad()`, and attention then launches the forward kernel alone.
`loss_fn` trains: next-token cross-entropy (plus the MoE aux loss) under
autograd, every attention's gradient from B5's backward kernels on the
card (`kernels.attention` is a `torch.autograd.Function`), and every MoE
expert GEMM's from B4's (`grouped_gemm` too), and every Mamba scan's from
B7's (`mamba_ssd`, float32: the layer lifts x, B and C). On the CPU all
five patterns train through the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import blocks as B
from .config import ModelConfig
from .layers import compute_float, embed, rmsnorm, truncated_normal
from .mamba import MambaState, _dims
from .xlstm import CONV_K, MLSTMState, SLSTMState, mlstm_dims

_BLOCKS = {
    "dense": (B.init_dense_block, B.dense_block),
    "parallel": (B.init_parallel_block, B.parallel_block),
    "moe": (B.init_moe_block, B.moe_layer_block),
}
# the pytree entries of a JAX `Model.init` whose leaves stack the layers:
# each name with the number of stacked dimensions (xlstm's mLSTM layers
# stack as (units, layers of a unit))
_STACKED = {"blocks": 1, "mamba": 1, "slstm": 1, "mlstm": 2}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when None; a CUDA device needs a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model runs on a CUDA device and none is "
                           "available; pass device='cpu' for the plain "
                           "PyTorch versions of the kernels")
    return dev


def ep_padded(cfg: ModelConfig, mesh) -> ModelConfig:
    """`cfg` with a MoE config's expert tables padded to a multiple of the
    mesh's "model" axis (`num_experts_padded`), as the JAX package's
    `Model.__post_init__` pads them."""
    if cfg.pattern != "moe" or mesh is None or "model" not in \
            mesh.axis_names:
        return cfg
    ep, m = mesh.shape["model"], cfg.moe
    pad = -(-m.num_experts // ep) * ep
    if pad == m.padded:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, num_experts_padded=pad))


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        if cfg.pattern not in _BLOCKS and cfg.pattern not in ("zamba2",
                                                              "xlstm"):
            raise ValueError(f"unknown pattern {cfg.pattern!r}")
        self.cfg = cfg = ep_padded(cfg, mesh)
        self.mesh = mesh
        dev = resolve_device(device)
        if mesh is not None and mesh.executes and mesh.device != dev:
            raise ValueError(f"the mesh runs on {mesh.device}, the model on "
                             f"{dev}")
        g = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        dtype, d, P = self.pdtype, cfg.d_model, torch.nn.Parameter
        self.embed = P(truncated_normal((cfg.vocab_size, d), 1.0, dtype, dev,
                                        g))
        self.final_norm = P(torch.ones((d,), dtype=dtype, device=dev))
        if not cfg.tie_embeddings:
            self.lm_head = P(truncated_normal((d, cfg.vocab_size), d ** -0.5,
                                              dtype, dev, g))
        if cfg.pattern in _BLOCKS:
            init_fn, _ = _BLOCKS[cfg.pattern]
            self.blocks = torch.nn.ModuleList(
                init_fn(cfg, dtype, dev, g) for _ in range(cfg.n_layers))
        elif cfg.pattern == "xlstm":
            per_m = cfg.xlstm.slstm_every - 1
            self.mlstm = torch.nn.ModuleList(
                torch.nn.ModuleList(B.init_mlstm_block(cfg, dtype, dev, g)
                                    for _ in range(per_m))
                for _ in range(self.units))
            self.slstm = torch.nn.ModuleList(
                B.init_slstm_block(cfg, dtype, dev, g)
                for _ in range(self.units))
        else:
            self.mamba = torch.nn.ModuleList(
                B.init_mamba_block(cfg, dtype, dev, g)
                for _ in range(cfg.n_layers))
            self.shared_attn = B.init_shared_attn_block(cfg, dtype, dev, g)

    # ------------------------------------------------------------------
    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.compute_dtype]

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the batch splits over."""
        if self.mesh is None:
            return ("data",)
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    def _block_kw(self) -> Dict:
        """The blocks' keyword arguments: the mesh, for the MoE layer."""
        return dict(mesh=self.mesh) if self.cfg.pattern == "moe" else {}

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def decayed(self) -> Dict[str, bool]:
        """{parameter name: whether AdamW decays it}: the JAX package's
        rule (ndim >= 2) on its leaves, which stack the layers (`_STACKED`
        dims more than the port's tensor a layer)."""
        return {n: p.ndim + _STACKED.get(n.partition(".")[0], 0) >= 2
                for n, p in self.named_parameters()}

    @property
    def n_apps(self) -> int:
        """zamba2: applications of the shared attention block."""
        return -(-self.cfg.n_layers // self.cfg.shared_attn_every)

    @property
    def units(self) -> int:
        """xlstm: units of slstm_every - 1 mLSTM layers and one sLSTM."""
        return self.cfg.n_layers // self.cfg.xlstm.slstm_every

    # ------------------------------------------------------------------
    def _default_positions(self, batch: int, seq: int, offset=0):
        pos = torch.arange(seq, dtype=torch.int32, device=self.device) \
            + offset
        pos = pos[None].expand(batch, seq)
        if self.cfg.rope_kind == "mrope":
            return pos[None].expand(3, batch, seq)
        return pos

    def _trunk(self, x, positions, caches=None, decode=False,
               cache_pos=None, seed=None):
        """Run the layers. Returns (x, states, aux): at decode `caches`,
        written in place; with `seed` (buffers from `init_caches`) the
        prefill states written into them; else the layers' states stacked
        as the JAX package's forward returns them. aux sums the MoE layers'
        aux losses (0 for the other patterns), at decode too."""
        cfg, S = self.cfg, x.shape[1]
        store = caches if decode else seed
        aux = torch.zeros((), dtype=compute_float(x.dtype), device=x.device)
        if cfg.pattern == "xlstm":
            x, states = self._xlstm_trunk(x, store, decode)
            return x, states, aux
        kv = store if cfg.pattern in _BLOCKS or store is None \
            else store["attn"]
        ks, vs, convs, ssms = [], [], [], []
        kw = self._block_kw()

        def attn_layer(fn, p, i):
            nonlocal x, aux
            c = (kv[0][i], kv[1][i]) if decode else None
            x, (k, v), a = fn(p, cfg, x, positions, c, decode=decode,
                              cache_pos=cache_pos, **kw)
            if a is not None:
                aux = aux + a
            if decode:
                return  # written in place
            if seed is not None:
                kv[0][i, :, :S] = k
                kv[1][i, :, :S] = v
            else:
                ks.append(k)
                vs.append(v)

        if cfg.pattern in _BLOCKS:
            _, block_fn = _BLOCKS[cfg.pattern]
            for i, p in enumerate(self.blocks):
                attn_layer(block_fn, p, i)
            return x, (store if store is not None
                       else (torch.stack(ks), torch.stack(vs))), aux

        every, L = cfg.shared_attn_every, cfg.n_layers
        for a in range(self.n_apps):
            attn_layer(B.dense_block, self.shared_attn, a)
            for i in range(a * every, min((a + 1) * every, L)):
                m = None if store is None else store["mamba"]
                st = MambaState(m.conv[i], m.ssm[i]) if decode else None
                x, new, _ = B.mamba_block(self.mamba[i], cfg, x, positions,
                                          st, decode=decode)
                if m is not None:
                    m.conv[i].copy_(new.conv)
                    m.ssm[i].copy_(new.ssm)
                else:
                    convs.append(new.conv)
                    ssms.append(new.ssm)
        if store is not None:
            return x, store, aux
        return x, {"mamba": MambaState(conv=torch.stack(convs),
                                       ssm=torch.stack(ssms)),
                   "attn": (torch.stack(ks), torch.stack(vs))}, aux

    def _xlstm_trunk(self, x, store, decode):
        """xlstm's units: slstm_every - 1 mLSTM layers, then one sLSTM
        layer. `store` (the decode caches or the prefill's seed buffers)
        takes each layer's new state in place; without it the states are
        stacked as the JAX package's forward returns them."""
        cfg = self.cfg
        new_m, new_s = [], []
        ms, tails = (None, None) if store is None else store["mlstm"]
        for u in range(self.units):
            unit = []
            for j, p in enumerate(self.mlstm[u]):
                c = (MLSTMState(ms.C[u, j], ms.n[u, j], ms.m[u, j]),
                     tails[u, j]) if decode else None
                x, (st, tl), _ = B.mlstm_block(p, cfg, x, None, c,
                                               decode=decode)
                if store is None:
                    unit.append((st, tl))
                    continue
                for buf, t in zip((ms.C, ms.n, ms.m, tails), (*st, tl)):
                    buf[u, j].copy_(t)
            new_m.append(unit)
            sc = SLSTMState(*(t[u] for t in store["slstm"])) if decode \
                else None
            x, st, _ = B.slstm_block(self.slstm[u], cfg, x, None, sc,
                                     decode=decode)
            if store is None:
                new_s.append(st)
                continue
            for buf, t in zip(store["slstm"], st):
                buf[u].copy_(t)
        if store is not None:
            return x, store

        def stack_m(field):
            return torch.stack([torch.stack([field(e) for e in unit])
                                for unit in new_m])
        return x, {
            "mlstm": (MLSTMState(*(stack_m(lambda e, i=i: e[0][i])
                                   for i in range(3))),
                      stack_m(lambda e: e[1])),
            "slstm": SLSTMState(*(torch.stack([st[i] for st in new_s])
                                  for i in range(4))),
        }

    def _hidden(self, tokens, embeds, positions, caches, decode, cache_pos,
                seed=None):
        """Embedding (or `embeds`, the modality-frontend stub path), the
        trunk and the final norm: (x, states, aux)."""
        if decode and caches is None:
            raise ValueError("decode needs the caches (init_caches, or "
                             "prefill's)")
        x = (embed(self.embed, tokens) if embeds is None else embeds).to(
            self.cdtype)
        if positions is None:
            off = cache_pos if decode and cache_pos is not None else 0
            positions = self._default_positions(x.shape[0], x.shape[1],
                                                offset=off)
        x, states, aux = self._trunk(x, positions, caches, decode,
                                     cache_pos, seed)
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps), states, aux

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x @ head).to(compute_float(x.dtype))

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens=None, embeds=None, positions=None, caches=None,
                decode=False, cache_pos=None):
        """Trunk + head: (logits, new_caches, aux). `embeds` (B, S, d)
        bypasses token embedding (qwen2-vl / musicgen); qwen2-vl's
        positions are (3, B, S). aux is the sum of the MoE layers' switch
        aux losses (0 for the other patterns), as the JAX package's layer
        stack sums them; at decode the port sums them too, where the JAX
        package's scanned decode loop returns 0."""
        x, new_caches, aux = self._hidden(tokens, embeds, positions, caches,
                                          decode, cache_pos)
        return self._logits(x), new_caches, aux

    # logits chunking kicks in when S·V reaches this (≈0.5G float32
    # elements): the full (B, S, V) logits are never materialized
    LOSS_CHUNK_THRESHOLD = 2 ** 29
    LOSS_CHUNK = 512

    def loss_fn(self, batch):
        """Next-token cross-entropy from float32 logits (+ the MoE aux
        loss times its weight), under autograd: (loss, {"nll", "aux"}).
        batch: "targets" (B, S) and "tokens" (B, S) or "embeds" (B, S, d),
        optionally "mask" (B, S) weighting each position. Where S·V >=
        LOSS_CHUNK_THRESHOLD, S % LOSS_CHUNK == 0 and there is no mask, the
        head and the cross-entropy run LOSS_CHUNK positions at a time, each
        chunk's logits recomputed in the backward (`torch.utils.
        checkpoint`, the JAX package's `jax.checkpoint` over `lax.scan`),
        so the full (B, S, V) logits never exist."""
        cfg = self.cfg
        targets = batch["targets"].long()
        Bsz, S = targets.shape
        mask = batch.get("mask")
        chunked = (S * cfg.vocab_size >= self.LOSS_CHUNK_THRESHOLD
                   and S % self.LOSS_CHUNK == 0 and mask is None)
        hidden, _, aux = self._hidden(batch.get("tokens"),
                                      batch.get("embeds"), None, None,
                                      False, None)
        if not chunked:
            nll = self._nll(hidden, targets)
            if mask is None:
                loss = nll.mean()
            else:
                mask = mask.to(nll.dtype)
                loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        else:
            C = self.LOSS_CHUNK
            total = torch.zeros((), dtype=torch.float32,
                                device=hidden.device)
            for c in range(0, S, C):
                total = total + checkpoint(
                    self._chunk_nll, hidden[:, c:c + C], targets[:, c:c + C],
                    use_reentrant=False)
            loss = total / (Bsz * S)
        w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
        return loss + w * aux, {"nll": loss, "aux": aux}

    def _nll(self, hidden, targets):
        """Per-position −log p(target) from float32 logits."""
        logits = self._logits(hidden)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None], dim=-1)
        return logz - gold[..., 0]

    def _chunk_nll(self, hidden, targets):
        return self._nll(hidden, targets).sum()

    def init_caches(self, batch: int, max_len: int):
        """Zeroed decode state in the compute dtype (SSM and LSTM states
        in float32, float64 for a float64 model). The xLSTM stabilizers m
        start at 0 here, as the JAX package's `init_caches` has them (the
        forward passes start them at −inf); a prefill overwrites them."""
        cfg, dt, dev, L = self.cfg, self.cdtype, self.device, \
            self.cfg.n_layers
        ft = compute_float(dt)

        def zeros(*shape, dtype=ft):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def attn_cache(n):
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return (torch.zeros(shape, dtype=dt, device=dev),
                    torch.zeros(shape, dtype=dt, device=dev))

        if cfg.pattern in _BLOCKS:
            return attn_cache(L)
        if cfg.pattern == "xlstm":
            U, M, d = self.units, cfg.xlstm.slstm_every - 1, cfg.d_model
            d_up, nh, hd = mlstm_dims(cfg)
            return {
                "mlstm": (MLSTMState(C=zeros(U, M, batch, nh, hd, hd),
                                     n=zeros(U, M, batch, nh, hd),
                                     m=zeros(U, M, batch, nh)),
                          zeros(U, M, batch, CONV_K - 1, d_up, dtype=dt)),
                "slstm": SLSTMState(*(zeros(U, batch, d) for _ in range(4))),
            }
        s, _, nh, conv_ch = _dims(cfg)
        return {
            "mamba": MambaState(
                conv=torch.zeros((L, batch, s.d_conv - 1, conv_ch),
                                 dtype=dt, device=dev),
                ssm=zeros(L, batch, nh, s.head_dim, s.d_state)),
            "attn": attn_cache(self.n_apps),
        }

    @torch.no_grad()
    def prefill(self, tokens=None, embeds=None, max_len=None):
        """Full-sequence forward seeding the decode caches: the attention
        k/v go into `max_len` buffers, the Mamba and LSTM layers' final
        states into theirs, layer by layer. Returns (logits of the last
        position (B, 1, V), caches): the head runs on that position only."""
        x = tokens if tokens is not None else embeds
        caches = self.init_caches(x.shape[0], max_len or x.shape[1])
        h, _, _ = self._hidden(tokens, embeds, None, None, False, None,
                               seed=caches)
        return self._logits(h[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, caches, tokens=None, embeds=None, cache_pos=0):
        """One token a row at position `cache_pos`: (logits (B, 1, V),
        caches), the caches written in place."""
        logits, new_caches, _ = self.forward(
            tokens=tokens, embeds=embeds, caches=caches, decode=True,
            cache_pos=cache_pos)
        return logits, new_caches


# ---------------------------------------------------------------------------
# parameters from the JAX package
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _as_tensor(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(cfg: ModelConfig, params: Dict,
                    device=None) -> Dict[str, torch.Tensor]:
    """The port's state dict (`Model.load_state_dict`) from the JAX
    package's `Model(cfg).init()` pytree given as numpy arrays (bf16 as
    ml_dtypes arrays): the layers' stacked leaves are split into one entry
    a layer — (L, ...) under "blocks", "mamba" and "slstm", (units, layers
    of a unit, ...) under "mlstm" — and zamba2's `shared_attn` kept whole.
    Layouts are the same in both packages. `device` as for `Model`."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, a in _leaves(params):
        top, _, rest = name.partition(".")
        t = _as_tensor(a).to(dev)
        if _STACKED.get(top) == 1:
            for i in range(t.shape[0]):
                out[f"{top}.{i}.{rest}"] = t[i]
        elif _STACKED.get(top) == 2:
            for i in range(t.shape[0]):
                for j in range(t.shape[1]):
                    out[f"{top}.{i}.{j}.{rest}"] = t[i, j]
        else:
            out[name] = t
    return out
