"""DuaLip's synthetic matching generator, in torch on the device.

The distribution of the upstream benchmark's generator
(``benchmark/generate_synthetic_data.py`` of linkedin/dualip): per
destination (row) a lognormal breadth ``Z``, scale ``s`` and value ``v``, a
Poisson edge count ``K_j`` with mean ``Z_j / sum Z * sparsity * n_dst *
n_src``; per edge a uniform source (column), duplicate (destination, source)
pairs merged; per source a lognormal affinity ``u``; per edge a lognormal
``eps``, ``c = min(v_j u_i eps, 0.5)`` and ``a = s_j c``; the budget ``b_j =
U(0.5, 1) * (greedy load_j + 1e-8)``, where each source puts its largest
``a`` (the first in row order on ties) on that edge's destination.  The LP
minimises ``-c``, so the cost handed on is ``-c``.

The destination side (``Z``, ``s``, ``v``, ``K`` and the ``U(0.5, 1)``
factors) is drawn from the configuration's ``destination_seed``, the upstream
benchmark's own seed, and the source side (sources, ``u``, ``eps``) from the
run's seed: every seed then gives the same edge count per destination, with
other columns, costs and budgets.
"""

from __future__ import annotations

import torch


def _sum_by_key(keys: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of ``vals`` (float64, each sum below 2^31) per key in ``[0, n)``, the same bits
    on every run: the values are summed as integers of 2^-32 (a float sum on
    the card, or a scan, may add in an order that changes from run to run)."""
    scale = 2.0 ** 32
    fixed = torch.round(vals * scale).to(torch.int64)
    return torch.zeros(n, dtype=torch.int64, device=vals.device).index_add_(0, keys, fixed).to(vals.dtype) / scale


def generate(params: dict, seed: int, device) -> dict:
    """The CSC arrays on ``device``: ``indptr`` (n+1,) int64, ``rows`` (nnz,)
    int32, ``a`` and ``c`` (nnz,) float32, ``b`` (m,) float32."""
    dev = torch.device(device)
    n_src, n_dst = int(params["num_sources"]), int(params["num_destinations"])
    f64 = torch.float64
    g_dst = torch.Generator(device=dev).manual_seed(int(params["destination_seed"]))
    g = torch.Generator(device=dev).manual_seed(int(seed))

    def lognormal(n, mean, std, gen):
        return torch.empty(n, dtype=f64, device=dev).log_normal_(mean, std, generator=gen)

    breadth = lognormal(n_dst, 0.0, 1.0, g_dst)
    rate = breadth / breadth.sum() * (float(params["target_sparsity"]) * n_dst) * n_src
    scale = lognormal(n_dst, 0.0, 1.0, g_dst)
    value = lognormal(n_dst, -4.0, 0.75, g_dst)
    counts = torch.clamp_max(torch.poisson(rate, generator=g_dst), n_src).to(torch.int64)
    rho = 0.5 + 0.5 * torch.rand(n_dst, dtype=f64, device=dev, generator=g_dst)
    del breadth, rate

    affinity = lognormal(n_src, 0.0, 0.5, g)
    dest = torch.repeat_interleave(torch.arange(n_dst, device=dev), counts)
    key = dest * n_src + torch.randint(0, n_src, (dest.numel(),), generator=g, device=dev)
    del dest
    key = torch.unique(key, sorted=True)  # destination-major, as the upstream dedupe leaves it
    dest, src = key // n_src, key % n_src
    del key
    c = torch.clamp_max(value[dest] * affinity[src] * lognormal(dest.numel(), 0.0, 0.5, g), 0.5)
    a = scale[dest] * c

    # CSC: source-major, rows ascending within a column
    col_key, order = torch.sort(src * n_dst + dest)
    del src, dest
    a, c = a[order], c[order]
    del order
    src, rows = col_key // n_dst, col_key % n_dst
    del col_key
    indptr = torch.zeros(n_src + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n_src), 0)

    best_a = torch.full((n_src,), -torch.inf, dtype=f64, device=dev).scatter_reduce_(0, src, a, "amax")
    pos = torch.nonzero(a == best_a[src]).flatten()
    first = torch.full((n_src,), a.numel(), dtype=torch.int64, device=dev).scatter_reduce_(0, src[pos], pos, "amin")
    first = first[first < a.numel()]
    load = _sum_by_key(rows[first], a[first], n_dst)
    b = rho * (load + 1e-8)
    return {"indptr": indptr, "rows": rows.to(torch.int32), "a": a.to(torch.float32),
            "c": (-c).to(torch.float32), "b": b.to(torch.float32)}
