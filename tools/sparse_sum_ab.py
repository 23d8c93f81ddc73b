"""Time the ways to sum a stored format's products on one card, at the sizes
of ``chip_smoke.py`` phase 15.

    python3 tools/sparse_sum_ab.py

The row sums of a CSR product at 216^3 (the Laplacian's pattern: 10,077,696
rows of up to 7 values, f32): ``torch.segment_reduce`` over the row
offsets on 1-D values (int32 and int64 offsets, and by lengths) and on the
values as one (nnz, 1) column; ``index_add_`` onto the row ids (atomics),
and the gather and the product before the sum.  Then BSR's block products,
cuBLAS's batched GEMM (``bmm``) against a broadcast product and a sum over
each block's columns, for 1,750,424 4 x 4 blocks (the 1M-row ``block4``
matrix) and 450,000 8 x 8 blocks (svdl's 600k x 400k matrix).  Each is
timed by CUDA events (the median of 3 batches of 10 calls), run twice to
see whether it gives the same bits, and held against an f64 sum.  It needs
a CUDA card.
"""

import statistics

import torch


def timed(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / reps)
    return statistics.median(samples)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sparse_sum_ab: needs a CUDA card")
    side = 216
    n = side**3
    i = torch.arange(n, device="cuda")
    cols = []
    for off in (-side * side, -side, -1, 0, 1, side, side * side):
        c = i + off
        cols.append(torch.where((c >= 0) & (c < n), c, -1))
    C = torch.stack(cols, 1)
    keep = C >= 0
    indices = C[keep].to(torch.int32)
    counts = keep.sum(1)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    indptr[1:] = torch.cumsum(counts, 0)
    indptr32 = indptr.to(torch.int32)
    row_ids = torch.repeat_interleave(
        torch.arange(n, device="cuda", dtype=torch.int32), counts)
    data = torch.randn(indices.numel(), device="cuda")
    x = torch.randn(n, device="cuda")
    v = data * torch.index_select(x, 0, indices)
    ways = {
        "segment_reduce 1-D, int32 offsets": lambda: torch.segment_reduce(
            v, "sum", offsets=indptr32),
        "segment_reduce 1-D, int64 offsets": lambda: torch.segment_reduce(
            v, "sum", offsets=indptr),
        "segment_reduce (nnz, 1), int32 offsets": lambda: torch.segment_reduce(
            v[:, None], "sum", offsets=indptr32, axis=0)[:, 0],
        "segment_reduce 1-D, lengths": lambda: torch.segment_reduce(
            v, "sum", lengths=counts),
        "index_add_ (atomics)": lambda: torch.zeros(
            n, device="cuda").index_add_(0, row_ids, v),
        "index_select (the gather alone)": lambda: torch.index_select(
            x, 0, indices),
        "data * gather (before the sum)": lambda: data * torch.index_select(
            x, 0, indices),
    }
    ref = torch.segment_reduce(v.double(), "sum", offsets=indptr).float()
    for name, fn in ways.items():
        y1, y2 = fn(), fn()
        err = (float((y1 - ref).abs().max()) if y1.shape == ref.shape
               else float("nan"))
        print(f"{name}: {timed(fn):.4f} ms, same bits twice "
              f"{torch.equal(y1, y2)}, max err against f64 {err:.2e}",
              flush=True)
    for nblk, bs in ((1_750_424, 4), (450_000, 8)):
        B = torch.randn(nblk, bs, bs, device="cuda")
        g = torch.randn(nblk, bs, device="cuda")

        def bmm():
            return torch.bmm(B, g[..., None])[..., 0]

        def broadcast():
            return torch.sum(B * g[:, None, :], dim=2)

        diff = float((bmm() - broadcast()).abs().max())
        print(f"{nblk} blocks of {bs} x {bs}: bmm {timed(bmm):.4f} ms, "
              f"broadcast and sum {timed(broadcast):.4f} ms, max difference "
              f"{diff:.2e}, broadcast the same bits twice "
              f"{torch.equal(broadcast(), broadcast())}", flush=True)


if __name__ == "__main__":
    main()
