"""Parameters from the JAX package, as numpy arrays, into the port's dict.

The caller turns the reference's pytree into numpy first (for example
``jax.tree.map(np.asarray, params)``, or a pickled checkpoint of the same),
so this module needs neither jax nor ml_dtypes: a bf16 array
(``ml_dtypes.bfloat16``) is reinterpreted through a ``uint16`` view.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.llama import LlamaConfig
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


def gpt2_params_from_numpy(tree: dict, cfg: GPT2Config, device="cuda") -> dict:
    """The reference's GPT-2 params (numpy leaves; dense, or mixture-of-
    experts when ``cfg.n_experts > 0``) as torch tensors on ``device`` (the
    card unless the caller asks for ``"cpu"``; a CUDA request with no GPU
    raises), key for key and in their own dtype. Raises on a missing or
    extra key or a shape that ``cfg`` does not expect."""
    return _from_numpy(tree, _gpt2_expected_shapes(cfg), device)


def llama_params_from_numpy(tree: dict, cfg: LlamaConfig, device="cuda") -> dict:
    """The reference's Llama params (numpy leaves) as torch tensors on
    ``device``, with the same checks and bf16 handling as
    :func:`gpt2_params_from_numpy`."""
    return _from_numpy(tree, _llama_expected_shapes(cfg), device)
