"""Weight-only int8, packed-int4 and int4xla quantization for the serving
LM, and the AWQ-style equalization that may precede int4xla.

Port of cosyvoice_tpu/utils/quant.py.  Each rewrites a float state_dict's
projection weights ([out, in]) into the layout of QDense(quant=...):
  int8: symmetric, per output channel: `weight` int8 [out, in], `scale` fp32 [out];
  int4: symmetric, group-wise along the input dim, range [-7, 7]: `weight`
        int8 [in/2, out] holding two input rows per byte (ops/kernels/
        int4_matmul.pack_int4), `scale` fp32 [in/g, out].  This is the one
        QDense mode whose weight is not [out, in]: it keeps the JAX package's
        packed layout.
  int4xla: the int4 grid unpacked: `weight` int8 [in, out] holding nibble
        values in [-7, 7] (the JAX kernel's layout), `scale` fp32 [in/g, out].
        The JAX package's native-int4 cast at the top of each decode program
        (int4_device_cast) is an XLA boundary trick and has no counterpart.
awq_equalize folds per-input-channel scales from models/llm.collect_act_stats
into the float weights before int4xla.  An input channel is a column of the
port's [out, in] weight (a row of the JAX kernel [in, out]).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
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


def quantize_kernel_int4xla(w: torch.Tensor, group_size: int = 128
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float weight -> (int8 nibble values [in, out] in [-7, 7],
    fp32 scale [in/g, out]) with g = min(group_size, in)."""
    w = w.float().t().contiguous()                     # [in, out]
    in_f, out = w.shape
    g = int(min(group_size, in_f))
    if in_f % g:
        raise ValueError(f"int4xla groups of {g} do not tile an input dim of {in_f}")
    wg = w.reshape(in_f // g, g, out)
    scale = wg.abs().amax(dim=1).clamp_min(1e-8) / 7.0          # [in/g, out]
    q = torch.round(wg / scale[:, None, :]).clamp(-7, 7)
    return q.reshape(in_f, out).to(torch.int8), scale.contiguous()


def quantize_qwen_int4xla(state_dict: dict, proj_names: Iterable[str] = PROJ_NAMES,
                          group_size: int = 128, act_amax: Optional[dict] = None,
                          prefix: str = "llm.model.model.") -> dict:
    """The layout of QDense(quant="int4xla") with quant_group=group_size;
    with `act_amax` (collect_act_stats), awq_equalize first."""
    if act_amax:
        state_dict = awq_equalize(state_dict, act_amax, prefix)
    return _rewrite_projs(state_dict, proj_names,
                          lambda w: quantize_kernel_int4xla(w, group_size))


def _awq_scales(amax) -> torch.Tensor:
    """s = (amax / geometric mean(amax))^0.5, clipped to [0.25, 4] (float64
    math, fp32 result, as the JAX package computes it)."""
    a = (amax.detach().cpu().double() if isinstance(amax, torch.Tensor)
         else torch.tensor(np.asarray(amax, np.float64))).clamp_min(1e-6)
    s = (a / torch.exp(torch.log(a).mean())) ** 0.5
    return s.clamp(0.25, 4.0).float()


def awq_equalize(state_dict: dict, act_amax: dict, prefix: str = "llm.model.model.") -> dict:
    """Fold per-input-channel equalization scales into the float weights of
    the Qwen2 body under `prefix` (exact at fp; quantization then sees
    re-balanced weights).

    act_amax: {layer: {"attn_in": [H], "mlp_in": [H], "down_in": [I]}}, the
    per-channel max |activation| at the q/k/v input, the gate/up input and
    the down_proj input.  For each, s = _awq_scales(amax): the consumers'
    input columns are multiplied by s and 1/s folds into the producer (the
    RMSNorm weight, or up_proj's output rows for down_proj).  As in the JAX
    package, the rewritten tensors come back in fp32 whatever their dtype
    was."""
    sd = dict(state_dict)
    f = lambda k: sd[k].float()
    for i, stats in act_amax.items():
        d = f"{prefix}layers.{int(i)}."
        dev = sd[d + "input_layernorm.weight"].device
        for norm, procs, key in (("input_layernorm", ("self_attn.q_proj", "self_attn.k_proj",
                                                      "self_attn.v_proj"), "attn_in"),
                                 ("post_attention_layernorm", ("mlp.gate_proj", "mlp.up_proj"),
                                  "mlp_in")):
            s = _awq_scales(stats[key]).to(dev)
            sd[d + norm + ".weight"] = f(d + norm + ".weight") / s
            for proj in procs:
                sd[d + proj + ".weight"] = f(d + proj + ".weight") * s[None, :]
        s = _awq_scales(stats["down_in"]).to(dev)
        sd[d + "mlp.up_proj.weight"] = sd[d + "mlp.up_proj.weight"] / s[:, None]
        sd[d + "mlp.down_proj.weight"] = f(d + "mlp.down_proj.weight") * s[None, :]
    return sd
