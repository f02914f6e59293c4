"""Parameter trees from numpy: the port's own module (the reference has no
counterpart), which carries a parameter or decode-cache tree of the JAX
package across to the port.

The reference's trees are nested dicts of arrays with the stacked
``layers`` axis first (two stacked axes for the hybrid's groups and the
VLM's super-blocks); the port's have the same keys and shapes, every
family's (MLA's latent projections and whisper's encoder included).  bfloat16
arrays (numpy's ``ml_dtypes.bfloat16``) keep their bits: they are viewed as
16-bit integers and reinterpreted as ``torch.bfloat16``, so a bf16 model
carries over exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)              # a writable copy: the cache is updated in place
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cuda") -> Any:
    """A nested dict of arrays (anything ``np.asarray`` takes) as the same
    dict of tensors, in the same dtypes, on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)
