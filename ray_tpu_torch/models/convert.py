"""Parameters from the JAX package, as numpy arrays, into the port's dict.

The caller turns the reference's pytree into numpy first (for example
``jax.tree.map(np.asarray, params)``, or a pickled checkpoint of the same),
so this module needs neither jax nor ml_dtypes: a bf16 array
(``ml_dtypes.bfloat16``) is reinterpreted through a ``uint16`` view.

Given a mesh whose ``tp`` axis has size > 1, each converter keeps only this
rank's part of each leaf for the serving engine (:func:`tp_shard`): the
whole tree is built on the CPU and only the rank's parts reach ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    P,
    shard_tree,
    shardings_from_logical,
)
from ray_tpu_torch.util.device import resolve_device


def _tensor(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _gpt2_expected_shapes(cfg: GPT2Config) -> dict:
    L, D, F_, V, S = cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq
    E = cfg.n_experts
    if E > 0:
        ffn = {
            "gate_w": (L, D, E),
            "exp_w1": (L, E, D, F_),
            "exp_b1": (L, E, F_),
            "exp_w2": (L, E, F_, D),
            "exp_b2": (L, D),
        }
    else:
        ffn = {"fc_w": (L, D, F_), "fc_b": (L, F_), "fc2_w": (L, F_, D), "fc2_b": (L, D)}
    return {
        "wte": (V, D),
        "wpe": (S, D),
        "lnf_scale": (D,),
        "lnf_bias": (D,),
        "blocks": {
            "ln1_scale": (L, D),
            "ln1_bias": (L, D),
            "qkv_w": (L, D, 3 * D),
            "qkv_b": (L, 3 * D),
            "proj_w": (L, D, D),
            "proj_b": (L, D),
            "ln2_scale": (L, D),
            "ln2_bias": (L, D),
            **ffn,
        },
    }


def _llama_expected_shapes(cfg: LlamaConfig) -> dict:
    L, D, F_, V, KD = cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.kv_dim
    return {
        "wte": (V, D),
        "blocks": {
            "attn_norm": (L, D),
            "wq": (L, D, D),
            "wk": (L, D, KD),
            "wv": (L, D, KD),
            "wo": (L, D, D),
            "mlp_norm": (L, D),
            "w_gate": (L, D, F_),
            "w_up": (L, D, F_),
            "w_down": (L, F_, D),
        },
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def _from_numpy(tree: dict, spec: dict, device) -> dict:
    """``tree``'s leaves as tensors on ``device``, key for key against
    ``spec``; raises on a missing or extra key or an unexpected shape."""
    device = resolve_device(device)

    def walk(node, spec, path):
        if set(node) != set(spec):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)} != {sorted(spec)}")
        out = {}
        for key, want in spec.items():
            if isinstance(want, dict):
                out[key] = walk(node[key], want, f"{path}{key}/")
                continue
            arr = np.asarray(node[key])
            if tuple(arr.shape) != want:
                raise ValueError(f"{path}{key}: shape {tuple(arr.shape)} != {want}")
            out[key] = _tensor(arr, device)
        return out

    return walk(tree, spec, "")


def tp_shard(params: dict, cfg, mesh: Mesh) -> dict:
    """This rank's part of every leaf of the whole tree ``params`` for
    serving under ``mesh``'s ``tp`` axis (``params`` itself where ``tp``
    has size 1). The blocks are ``DEFAULT_RULES``' (the vocabulary and the
    MLP's columns and rows), but the attention weights are split by heads:
    each rank takes a contiguous block of them
    (:func:`~ray_tpu_torch.models.gpt2.head_block`, uneven where ``tp``
    does not divide ``n_head``). GPT-2's fused ``qkv_w``/``qkv_b`` keep
    this rank's heads' q, k and v columns
    (:func:`~ray_tpu_torch.models.gpt2.heads_columns`) and ``proj_w`` their
    rows; Llama's ``wq`` their columns, ``wo`` their rows, and ``wk``/``wv``
    (whole under the rule) the columns of the KV heads those query heads
    read (:func:`~ray_tpu_torch.models.llama.kv_heads`). So the serving
    path takes its heads once, at load, and gathers nothing per layer; the
    two all-reduces a layer sum the ranks' parts as they do for even
    blocks. Split leaves are compact copies on the leaves' device."""
    tp = mesh.size("tp")
    if tp == 1:
        return params
    family = llama if isinstance(cfg, LlamaConfig) else gpt2
    shardings = shardings_from_logical(family.param_logical_specs(cfg), DEFAULT_RULES, mesh)
    r, Dh = mesh.coordinate("tp"), cfg.head_dim
    lo, hi = gpt2.head_block(cfg.n_head, tp, r)

    def columns(t):
        return t[..., lo * Dh:hi * Dh]

    def rows(t):
        return t[..., lo * Dh:hi * Dh, :]

    if family is llama:
        kv = llama.kv_heads(cfg, tp, r)
        own = {"wq": columns, "wo": rows, "wk": lambda t: llama.kv_columns(t, kv, Dh)}
        own["wv"] = own["wk"]
    else:
        own = {"qkv_w": lambda t: gpt2.heads_columns(t, cfg, tp, r), "proj_w": rows}
        own["qkv_b"] = own["qkv_w"]
    shardings["blocks"].update(dict.fromkeys(own, NamedSharding(mesh, P())))
    out = shard_tree(params, shardings)
    blocks = {k: take(params["blocks"][k]).clone() for k, take in own.items()}
    out["blocks"] = dict(out["blocks"], **blocks)
    return out


def _load(tree: dict, spec: dict, cfg, device, mesh: Mesh | None) -> dict:
    if mesh is None or mesh.size("tp") == 1:
        return _from_numpy(tree, spec, device)
    device = resolve_device(device)
    local = tp_shard(_from_numpy(tree, spec, "cpu"), cfg, mesh)

    def to(node):
        return {k: to(v) if isinstance(v, dict) else v.to(device) for k, v in node.items()}

    return to(local)


def gpt2_params_from_numpy(
    tree: dict, cfg: GPT2Config, device="cuda", mesh: Mesh | None = None
) -> dict:
    """The reference's GPT-2 params (numpy leaves; dense, or mixture-of-
    experts when ``cfg.n_experts > 0``) as torch tensors on ``device`` (the
    card unless the caller asks for ``"cpu"``; a CUDA request with no GPU
    raises), key for key and in their own dtype. Raises on a missing or
    extra key or a shape that ``cfg`` does not expect. With ``mesh``, only
    this rank's serving part of each leaf (:func:`tp_shard`)."""
    return _load(tree, _gpt2_expected_shapes(cfg), cfg, device, mesh)


def llama_params_from_numpy(
    tree: dict, cfg: LlamaConfig, device="cuda", mesh: Mesh | None = None
) -> dict:
    """The reference's Llama params (numpy leaves) as torch tensors on
    ``device``, with the same checks, bf16 handling and ``mesh`` as
    :func:`gpt2_params_from_numpy`."""
    return _load(tree, _llama_expected_shapes(cfg), cfg, device, mesh)
