"""Sharding policies: logical parameter/activation axes → mesh axes → DTensor
placements; the port of ``repro/sharding/policies.py``.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model') multi-pod.

Policy 'fsdp_tp' (default):
  * every ≥1-D weight is sharded over 'data' on its 'embed' axis (ZeRO-3
    style full parameter+optimizer sharding),
  * 'heads'/'ff'/'experts'/'vocab'/'ssm_in' shard over 'model' (TP/EP),
  * axes that don't divide the mesh axis fall back to replication
    (e.g. granite's vocab 49155 is odd → vocab unsharded).

Activations: batch over ('pod','data') (pure DP across pods), model-parallel
dims over 'model'; decode KV caches shard batch over data and kv-heads (or
sequence) over 'model'.

A spec is the reference's ``PartitionSpec`` content as a tuple: one entry a
tensor dim, each None, a mesh-axis name or a tuple of names, so a test
holds it to the reference entry by entry.  ``to_placements`` is the one
converter from a spec to DTensor placements.  Where two mesh axes split
one dim, DTensor splits in mesh-dim order; JAX splits in the spec's order.
The two agree except for the ``serve`` policy's ``embed → ("model",
"data")``: the local shard sizes are the same, which rank holds which
block is not (a stated deviation; no placement here depends on it).

The functions read a mesh's ``mesh_dim_names`` and ``shape`` only, so they
take a ``DeviceMesh`` or a ``launch.mesh.MeshLayout`` alike; ``Sharding``
(a mesh and a spec) is the counterpart of ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.tensor import Replicate, Shard

# priority lists per logical axis: first mesh axis that divides wins
PARAM_RULES: dict[str, tuple] = {
    "layers": (),
    "vocab": ("model",),
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),          # fallback TP axis for GQA handled in resolve()
    "ff": ("model",),
    "experts": ("model",),
    "ssm_in": ("model",),
    "ssm_heads": ("model",),
    "conv": (),
    "state": (),
}

# Policy presets:
#   fsdp_tp  — ZeRO-3 over 'data' + TP/EP over 'model' (baseline)
#   dp_only  — params replicated, batch over BOTH axes (pure DP)
#   fsdp_2d  — params sharded over both axes on the same dim where possible
#   serve    — weight contraction dims 2-D (embed→model, ff→data,
#              experts→model): decode pays small activation all-reduces
#              instead of FSDP weight gathers
POLICIES: dict[str, dict[str, tuple]] = {
    "fsdp_tp": PARAM_RULES,
    "fsdp_tp_hd": PARAM_RULES,   # + GQA head_dim TP fallback (see below)
    "dp_only": {ax: () for ax in PARAM_RULES},
    "fsdp_2d": {**PARAM_RULES, "embed": (("data", "model"), "data")},
    "serve": {
        "layers": (), "vocab": ("model",), "embed": ("model", "data"),
        "heads": (), "kv_heads": (), "head_dim": (), "ff": ("data",),
        "experts": ("model",), "ssm_in": ("model",), "ssm_heads": ("model",),
        "conv": (), "state": (),
    },
}

# batch/activation DP axes per policy (model axis joins DP for dp_only)
POLICY_DP: dict[str, tuple[str, ...]] = {
    "fsdp_tp": ("data",),
    "fsdp_tp_hd": ("data",),
    "dp_only": ("data", "model"),
    "fsdp_2d": ("data",),
    "serve": ("data",),
}


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[name]


def _fits(mesh, dim: int, mesh_axis) -> bool:
    if isinstance(mesh_axis, tuple):
        size = 1
        for a in mesh_axis:
            if a not in mesh.mesh_dim_names:
                return False
            size *= _axis_size(mesh, a)
        return dim % size == 0
    return (mesh_axis in mesh.mesh_dim_names
            and dim % _axis_size(mesh, mesh_axis) == 0)


def to_placements(spec: Optional[tuple], mesh) -> tuple:
    """DTensor placements (one a mesh dim) of ``spec`` on ``mesh``: mesh
    dim ``j`` is ``Shard(i)`` where entry ``i`` names it, else
    ``Replicate()``.  None is every dim replicated."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for i, entry in enumerate(spec or ()):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            j = mesh.mesh_dim_names.index(name)
            if out[j] != Replicate():
                raise ValueError(f"mesh axis {name!r} used twice in {spec}")
            out[j] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def resolve_param_spec(axes: tuple, shape: tuple, mesh,
                       policy: str = "fsdp_tp") -> tuple:
    """Map one parameter's logical axes to a spec.

    Embedding/unembedding tables are vocab-parallel only (Megatron style):
    sharding their d_model axis over 'data' makes the unembed contraction
    dim and the batch dim compete for the same mesh axis."""
    rules = POLICIES[policy]
    spec: list = []
    used: set = set()
    vocab_table = "vocab" in axes
    for ax_name, dim in zip(axes, shape):
        if vocab_table and ax_name == "embed":
            spec.append(None)
            continue
        chosen = None
        for mesh_axis in rules.get(ax_name, ()):
            names = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
            if _fits(mesh, dim, mesh_axis) and not (set(names) & used):
                chosen = mesh_axis
                break
        spec.append(chosen)
        if chosen:
            used.update(chosen if isinstance(chosen, tuple) else (chosen,))
    # GQA head_dim TP fallback — opt-in only ('fsdp_tp_hd'): sharding
    # head_dim puts the QKᵀ contraction dim on 'model', a partial-sum
    # all-reduce of every score tensor.
    if (policy == "fsdp_tp_hd" and "kv_heads" in axes
            and "model" not in used and "head_dim" in axes):
        i = axes.index("head_dim")
        if shape[i] % _axis_size(mesh, "model") == 0:
            spec[i] = "model"
    return tuple(spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def param_shardings(cfg, mesh, axes_tree, params_tree,
                    policy: str = "fsdp_tp"):
    """Tree of ``Sharding`` matching params (``axes_tree`` mirrors them;
    a params leaf is anything with a ``shape``)."""
    if _is_axes(axes_tree):
        return Sharding(mesh, resolve_param_spec(axes_tree,
                                                 tuple(params_tree.shape),
                                                 mesh, policy))
    return {k: param_shardings(cfg, mesh, axes_tree[k], params_tree[k],
                               policy) for k in axes_tree}


def dp_axes(mesh, policy: str = "fsdp_tp") -> tuple[str, ...]:
    base = POLICY_DP.get(policy, ("data",))
    return (("pod",) + base) if "pod" in mesh.mesh_dim_names else base


def _div(dim: int, mesh, axes: tuple[str, ...]) -> Optional[tuple]:
    size = 1
    for a in axes:
        size *= _axis_size(mesh, a)
    return axes if dim % size == 0 else None


def batch_sharding(cfg, mesh, batch_specs: dict,
                   policy: str = "fsdp_tp") -> dict:
    """Shardings for a train/prefill batch dict."""
    dp = dp_axes(mesh, policy)
    out = {}
    for k, leaf in batch_specs.items():
        b = leaf.shape[0]
        dpa = _div(b, mesh, dp) or _div(b, mesh, ("data",))
        out[k] = Sharding(mesh, (dpa if dpa else None,)
                          + (None,) * (len(leaf.shape) - 1))
    return out


def cache_shardings(cfg, mesh, cache_specs, seq_axis_ok: bool = True,
                    policy: str = "fsdp_tp"):
    """Decode-cache shardings.  KV caches (L,B,T,K,hd): batch→data,
    kv-heads→model (or, when they do not divide, the sequence →model; a
    batch-1 long context shards T over data).  SSM states (L,B,H,N,P):
    batch→data, H→model.  ``policy`` is accepted as in the reference,
    whose cache DP axes are always the default policy's."""
    dp = dp_axes(mesh)

    def one(path_hint, leaf):
        shp = tuple(leaf.shape)
        if path_hint in ("k", "v"):  # (L|sites, B, T, K, hd) KV cache
            _, b, t, k, hd = shp
            dpa = _div(b, mesh, dp) or _div(b, mesh, ("data",))
            kv_ax = "model" if k % _axis_size(mesh, "model") == 0 else None
            t_ax = None
            if kv_ax is None and t % _axis_size(mesh, "model") == 0:
                t_ax = "model"
            elif (dpa is None and seq_axis_ok
                  and t % _axis_size(mesh, "data") == 0):
                t_ax = "data"  # batch-1 long context: SP over data instead
            return Sharding(mesh, (None, dpa, t_ax, kv_ax, None))
        if path_hint == "state":  # (L,B,H,N,P) SSM state
            _, b, h, n, p = shp
            dpa = _div(b, mesh, dp) or _div(b, mesh, ("data",))
            h_ax = "model" if h % _axis_size(mesh, "model") == 0 else None
            return Sharding(mesh, (None, dpa, h_ax, None, None))
        if path_hint == "conv":  # (L,B,w-1,ch)
            _, b, _, ch = shp
            dpa = _div(b, mesh, dp) or _div(b, mesh, ("data",))
            ch_ax = "model" if ch % _axis_size(mesh, "model") == 0 else None
            return Sharding(mesh, (None, dpa, None, ch_ax))
        if path_hint == "enc_out":  # (B, T, d)
            dpa = _div(shp[0], mesh, dp) or _div(shp[0], mesh, ("data",))
            return Sharding(mesh, (dpa, None, None))
        return Sharding(mesh, (None,) * len(shp))

    def walk(tree, hint=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return one(hint, tree)

    return walk(cache_specs)


def activation_specs(cfg, mesh, global_batch: int,
                     policy: str = "fsdp_tp") -> dict:
    """Specs for the block-boundary activation constraints (``shard_act``).

    'btd' — (batch, seq, d_model): batch over DP axes.
    'btv' — logits (batch, seq, vocab): batch over DP, vocab over model if
            divisible.
    The MoE buffers: 'ecd' (experts, capacity, d), 'td' (tokens, d),
    'gtec'/'gecd' (the grouped dispatch's group-major tensors).
    Falls back to None entries when the batch doesn't divide DP (batch-1
    long-context decode)."""
    dp = dp_axes(mesh, policy)
    dpa = _div(global_batch, mesh, dp) or _div(global_batch, mesh, ("data",))
    v_ax = ("model" if cfg.vocab % _axis_size(mesh, "model") == 0
            and "model" not in (dpa or ()) else None)
    moe = {}
    if cfg.moe is not None:
        e_ax = ("model" if cfg.moe.n_experts % _axis_size(mesh, "model") == 0
                else None)
        # capacity/token dims shard over 'data' only
        moe = {"ecd": (e_ax, "data", None), "td": ("data", None),
               "gtec": ("data", None, e_ax, None),
               "gecd": ("data", e_ax, None, None)}
    if dpa is None:
        return {"btd": None,
                "btv": (None, None, v_ax) if v_ax else None, **moe}
    return {"btd": (dpa, None, None), "btv": (dpa, None, v_ax), **moe}


def ssm_state_sharding(mesh, leaf) -> Sharding:
    """(L,B,H,N,P): batch→data, heads→model."""
    dp = dp_axes(mesh)
    _, b, h, n, p = leaf.shape
    dpa = _div(b, mesh, dp) or _div(b, mesh, ("data",))
    h_ax = "model" if h % _axis_size(mesh, "model") == 0 else None
    return Sharding(mesh, (None, dpa, h_ax, None, None))
