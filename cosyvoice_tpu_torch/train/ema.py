"""Exponential moving average of parameters.  Port of
cosyvoice_tpu/train/ema.py: the shadow is a dict of tensors keyed by
parameter name, shadow = decay * shadow + (1 - decay) * param."""
from __future__ import annotations

import torch


def ema_init(params: dict) -> dict:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(shadow: dict, params: dict, decay: float = 0.999) -> dict:
    return {k: decay * s + (1.0 - decay) * params[k].detach() for k, s in shadow.items()}
