"""Parameters from the reference package, as numpy arrays, into the
port's tree: same keys, shapes and dtypes, so both packages compute
the same function on the same weights."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import resolve_device


def params_from_numpy(tree, device="cuda"):
    """Nested dict of array-likes -> same dict of tensors on ``device``,
    dtypes kept."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return walk(tree)
