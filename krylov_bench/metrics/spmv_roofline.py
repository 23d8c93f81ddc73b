"""``spmv_roofline`` (layer: kernels), %: the SpMV kernel's byte bound at the
data sheet's memory rate over its device time for one product, in the
traced solves.  Every input is counted read once and every output written
once: the stencil reads x and writes y, 8 bytes a row in float32, summed
over the launches of one product.  On several cards the trace is rank 0's,
whose product covers its own rows, ``rows / chips``."""


def product_bytes(family: str, config: dict, chips: int = 1) -> int:
    if family == "stencil":
        return 8 * int(config["rows"]) // int(chips)
    raise ValueError(f"no byte count for the kernel family {family!r}")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    family = run.config["spmv_kernel"]
    ops = run.family_ops(family)
    if not ops:
        return None
    products = len(ops) / run.launches_per_product(family)
    seconds = sum(b - a for a, b, _ in ops) * 1e-6 / products
    bound = (product_bytes(family, run.config, run.cell.chips)
             / run.peaks["memory_bytes_per_s"])
    return 100.0 * bound / seconds
