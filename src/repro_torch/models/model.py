"""The LM, the port of the JAX package's `models/model.py` for the dense,
parallel and zamba2 patterns: init, forward, prefill, decode and the
decode caches, with a Python loop over the layers (no scan).

`Model(cfg, device=None)` builds its parameters on `device` (CUDA when
None: it raises without a card; the tests pass "cpu") from a seeded
`torch.Generator`. `from_jax_params` carries a JAX `Model.init` pytree
across (the layouts are the JAX package's, so it only renames).

Caches keep the JAX package's structure and stacking: (k, v) of (L, B, T,
KV, hd) for the dense and parallel patterns; for zamba2 {"mamba":
MambaState(conv (L, B, d_conv-1, C), ssm (L, B, nh, hd, ds) float32),
"attn": (k, v) of (n_apps, B, T, KV, hd)}. `cache[i]` is a contiguous
layer, as the decode kernel takes it. Where the JAX package returns updated
copies, the port writes the caches in place: `prefill` fills buffers from
`init_caches` layer by layer and `decode_step` writes slot `cache_pos`.

Serving only: the entry points run under `torch.no_grad()`. The kernels
have no backward yet; the training half (`loss_fn`, the custom VJP) is
ROADMAP item A11c, the MoE and xLSTM patterns A11b.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import blocks as B
from .config import ModelConfig
from .layers import compute_float, embed, rmsnorm, truncated_normal
from .mamba import MambaState, _dims

_BLOCKS = {
    "dense": (B.init_dense_block, B.dense_block),
    "parallel": (B.init_parallel_block, B.parallel_block),
    "moe": (B.init_moe_block, B.moe_layer_block),
}
# the pytree entries of a JAX `Model.init` whose leaves stack the layers
_STACKED = ("blocks", "mamba")
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


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.pattern == "xlstm":
            raise NotImplementedError("the xLSTM pattern is not ported yet: "
                                      "ROADMAP item A11b")
        if cfg.pattern not in _BLOCKS and cfg.pattern != "zamba2":
            raise ValueError(f"unknown pattern {cfg.pattern!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
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

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @property
    def n_apps(self) -> int:
        """zamba2: applications of the shared attention block."""
        return -(-self.cfg.n_layers // self.cfg.shared_attn_every)

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
        """Run the layers. Returns (x, states): at decode `caches`, written
        in place; with `seed` (buffers from `init_caches`) the prefill
        states written into them; else the layers' states stacked as the
        JAX package's forward returns them."""
        cfg, S = self.cfg, x.shape[1]
        store = caches if decode else seed
        kv = store if cfg.pattern in _BLOCKS or store is None \
            else store["attn"]
        ks, vs, convs, ssms = [], [], [], []

        def attn_layer(fn, p, i):
            nonlocal x
            c = (kv[0][i], kv[1][i]) if decode else None
            x, (k, v), _ = fn(p, cfg, x, positions, c, decode=decode,
                              cache_pos=cache_pos)
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
                       else (torch.stack(ks), torch.stack(vs)))

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
            return x, store
        return x, {"mamba": MambaState(conv=torch.stack(convs),
                                       ssm=torch.stack(ssms)),
                   "attn": (torch.stack(ks), torch.stack(vs))}

    def _hidden(self, tokens, embeds, positions, caches, decode, cache_pos,
                seed=None):
        """Embedding (or `embeds`, the modality-frontend stub path), the
        trunk and the final norm."""
        if decode and caches is None:
            raise ValueError("decode needs the caches (init_caches, or "
                             "prefill's)")
        x = (embed(self.embed, tokens) if embeds is None else embeds).to(
            self.cdtype)
        if positions is None:
            off = cache_pos if decode and cache_pos is not None else 0
            positions = self._default_positions(x.shape[0], x.shape[1],
                                                offset=off)
        x, states = self._trunk(x, positions, caches, decode, cache_pos,
                                seed)
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps), states

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
        positions are (3, B, S). aux is 0 (no MoE layer yet)."""
        x, new_caches = self._hidden(tokens, embeds, positions, caches,
                                     decode, cache_pos)
        aux = torch.zeros((), device=x.device)
        return self._logits(x), new_caches, aux

    def init_caches(self, batch: int, max_len: int):
        """Zeroed decode state in the compute dtype (SSM states in
        float32, float64 for a float64 model)."""
        cfg, dt, dev, L = self.cfg, self.cdtype, self.device, \
            self.cfg.n_layers

        def attn_cache(n):
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            return (torch.zeros(shape, dtype=dt, device=dev),
                    torch.zeros(shape, dtype=dt, device=dev))

        if cfg.pattern in _BLOCKS:
            return attn_cache(L)
        s, _, nh, conv_ch = _dims(cfg)
        return {
            "mamba": MambaState(
                conv=torch.zeros((L, batch, s.d_conv - 1, conv_ch),
                                 dtype=dt, device=dev),
                ssm=torch.zeros((L, batch, nh, s.head_dim, s.d_state),
                                dtype=compute_float(dt), device=dev)),
            "attn": attn_cache(self.n_apps),
        }

    @torch.no_grad()
    def prefill(self, tokens=None, embeds=None, max_len=None):
        """Full-sequence forward seeding the decode caches: the attention
        k/v go into `max_len` buffers, the Mamba layers' final states into
        theirs, layer by layer. Returns (logits of the last position (B, 1,
        V), caches): the head runs on that position only."""
        x = tokens if tokens is not None else embeds
        caches = self.init_caches(x.shape[0], max_len or x.shape[1])
        h, _ = self._hidden(tokens, embeds, None, None, False, None,
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
    ml_dtypes arrays): the layers' stacked (L, ...) leaves are split into
    one entry a layer, zamba2's `shared_attn` kept whole. Layouts are the
    same in both packages. `device` as for `Model`."""
    if cfg.pattern not in ("dense", "parallel", "zamba2"):
        raise NotImplementedError(f"pattern {cfg.pattern!r} is not ported "
                                  "yet: ROADMAP item A11b")
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, a in _leaves(params):
        top, _, rest = name.partition(".")
        t = _as_tensor(a).to(dev)
        if top in _STACKED:
            for i in range(t.shape[0]):
                out[f"{top}.{i}.{rest}"] = t[i]
        else:
            out[name] = t
    return out

