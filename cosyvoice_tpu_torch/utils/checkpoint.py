"""Load a released checkpoint's tensors into a port module by name."""
from __future__ import annotations

import numpy as np
import torch

# state_dict entries that no importer of the JAX package reads
UNREAD = ("num_batches_tracked",)


def load_by_name(module: torch.nn.Module, tensors: dict, source: str = "checkpoint") -> None:
    """Copy `tensors[name]` into every state_dict entry of `module` (cast to
    the entry's dtype); entries named in UNREAD may be absent.  A missing
    name raises KeyError, a shape mismatch RuntimeError; tensors the module
    has no entry for (a tied lm_head, export-only constants) are ignored."""
    wanted = [k for k in module.state_dict() if not k.endswith(UNREAD)]
    missing = [k for k in wanted if k not in tensors]
    if missing:
        raise KeyError(f"{source}: {len(missing)} weights missing, e.g. {missing[:5]} "
                       f"(it holds e.g. {sorted(tensors)[:5]})")
    state = {}
    for k in wanted:
        v = tensors[k]
        state[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    module.load_state_dict(state, strict=False)
