"""The one generator of right-hand sides, driven by a traffic file's
``rhs`` entry.

``{"kind": "normal", "pool": P}``: P vectors of independent standard normal
entries.  Every seed draws the same number of vectors of the same size from
a ``torch.Generator`` on the device, so seeds change the values and never
the work.
"""

from __future__ import annotations

import torch


def rhs_pool(spec: dict, rows: int, seed: int, device):
    """A ``(pool, rows)`` float32 tensor on ``device``; solve ``i`` takes row
    ``i % pool``."""
    if spec["kind"] != "normal":
        raise ValueError(f"unknown right-hand side kind {spec['kind']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn((int(spec["pool"]), rows), generator=gen,
                       dtype=torch.float32, device=device)
