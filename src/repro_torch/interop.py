"""Parameters between the JAX reference's layout and the port's.

The input of :func:`params_from_numpy` is a nested dict of numpy arrays
shaped like the reference's parameters after ``unbox`` and ``np.asarray``
(the caller does that conversion on the JAX side). The reference stacks
the layers of ``blocks`` on a leading (L, ...) axis for ``lax.scan``; the
port keeps a list of L per-layer dicts. :func:`params_to_numpy` is the
inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.param import resolve_device, tree_map


def _to_tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":   # ml_dtypes bf16: no torch equivalent
        return torch.as_tensor(x.astype(np.float32), device=device) \
            .to(torch.bfloat16)
    return torch.tensor(x, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _split_layers(stacked):
    """{..., leaf (L, ...)} → [{..., leaf (...)} for each of the L layers]."""
    if isinstance(stacked, dict):
        parts = {k: _split_layers(v) for k, v in stacked.items()}
        n = {len(v) for v in parts.values()}
        if len(n) != 1:
            raise ValueError(f"stacked block leaves disagree on the layer "
                             f"count: {sorted(n)}")
        return [{k: v[i] for k, v in parts.items()} for i in range(n.pop())]
    return list(stacked)


def _stack_layers(layers):
    """Inverse of :func:`_split_layers`."""
    if isinstance(layers[0], dict):
        return {k: _stack_layers([lay[k] for lay in layers])
                for k in layers[0]}
    return np.stack(layers)


def params_from_numpy(tree, device=None):
    """Reference-layout numpy tree → port params (torch tensors on
    ``device``, default CUDA)."""
    device = resolve_device(device)
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out = tree_map(lambda x: _to_tensor(x, device), out)
    if "blocks" in tree:
        out["blocks"] = [tree_map(lambda x: _to_tensor(x, device), layer)
                         for layer in _split_layers(tree["blocks"])]
    return out


def params_to_numpy(params):
    """Port params → reference-layout numpy tree (``blocks`` stacked)."""
    out = {k: tree_map(_to_numpy, v) for k, v in params.items()
           if k != "blocks"}
    if "blocks" in params:
        out["blocks"] = _stack_layers([tree_map(_to_numpy, layer)
                                       for layer in params["blocks"]])
    return out
