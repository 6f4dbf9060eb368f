"""Weight-only int8 and packed-int4 quantization for the serving LM.

Port of the int8 and int4 parts of cosyvoice_tpu/utils/quant.py.  Each
rewrites a float state_dict's projection weights ([out, in]) into the layout
of QDense(quant=...):
  int8: symmetric, per output channel: `weight` int8 [out, in], `scale` fp32 [out];
  int4: symmetric, group-wise along the input dim, range [-7, 7]: `weight`
        int8 [in/2, out] holding two input rows per byte (ops/kernels/
        int4_matmul.pack_int4), `scale` fp32 [in/g, out].  This is the one
        QDense mode whose weight is not [out, in]: it keeps the JAX package's
        packed layout.
"""
from __future__ import annotations

from typing import Iterable

import torch

from cosyvoice_tpu_torch.ops.kernels.int4_matmul import pack_int4

PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def quantize_kernel_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float weight -> (int8 [out, in], fp32 scale [out])."""
    w = w.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_kernel_int4(w: torch.Tensor, group_size: int = 128
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float weight -> (packed int8 [in/2, out], fp32 scale
    [in/g, out]) with g = min(group_size, in)."""
    w = w.float().t().contiguous()                     # [in, out]
    in_f, out = w.shape
    g = int(min(group_size, in_f))
    if in_f % g or g % 2:
        raise ValueError(f"int4 groups of {g} do not tile an input dim of {in_f}")
    wg = w.reshape(in_f // g, g, out)
    scale = wg.abs().amax(dim=1).clamp_min(1e-8) / 7.0          # [in/g, out]
    q = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    return pack_int4(q.reshape(in_f, out).to(torch.int8)), scale.contiguous()


def _rewrite_projs(state_dict: dict, proj_names: Iterable[str], quantize_one) -> dict:
    """Every `<proj>.weight` of the named projections becomes the quantized
    weight + `<proj>.scale`."""
    names = tuple(f"{n}.weight" for n in proj_names)
    out = {}
    for key, value in state_dict.items():
        if key.endswith(names):
            out[key], out[key[:-len("weight")] + "scale"] = quantize_one(value)
        else:
            out[key] = value
    return out


def quantize_qwen_int8(state_dict: dict, proj_names: Iterable[str] = PROJ_NAMES) -> dict:
    """The layout of QDense(quant="int8")."""
    return _rewrite_projs(state_dict, proj_names, quantize_kernel_int8)


def quantize_qwen_int4(state_dict: dict, proj_names: Iterable[str] = PROJ_NAMES,
                       group_size: int = 128) -> dict:
    """The layout of QDense(quant="int4") with quant_group=group_size."""
    return _rewrite_projs(state_dict, proj_names,
                          lambda w: quantize_kernel_int4(w, group_size))
