"""``halo_stencil_roofline`` (layer: kernels), %: rank 0's product on the
mesh, one launch of the stencil kernel's halo form, against its byte bound
at the data sheet's memory rate, over its device time a launch in the
traced solves.  Every input is counted read once and every output written
once: the rank's block of x read and of y written, and the two exchanged
planes read, ``8 * rows / chips + 2 * 4 * plane`` bytes in float32.  A
program whose mesh product is no such launch (one card, or the one-card
launch on the block with the edge terms added after it) gives nothing."""

import re

# the halo overload of csrc/stencil.cuh's stencil_kernel takes a StencilHalo
HALO = re.compile(r"\bstencil_kernel<.*\bStencilHalo\b")


def product_bytes(config: dict, chips: int) -> int:
    """Bytes of one rank's product: a plane is the grid's rows of one value
    of its slowest axis, the halo exchange's slab."""
    plane = int(config["grid"][1]) * int(config["grid"][2])
    return 8 * int(config["rows"]) // int(chips) + 2 * 4 * plane


def read(run):
    if run.trace is None or run.peaks is None or run.cell.chips < 2:
        return None
    ops = [op for op in run.trace.solve_ops() if HALO.search(op[2])]
    if not ops:
        return None
    seconds = sum(b - a for a, b, _ in ops) * 1e-6 / len(ops)
    bound = (product_bytes(run.config, run.cell.chips)
             / run.peaks["memory_bytes_per_s"])
    return 100.0 * bound / seconds
