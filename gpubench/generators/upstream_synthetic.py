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

``generate_part`` makes the same law in parts, one contiguous range of
sources a part, each on its own device: ``K_j`` is split over the parts by a
multinomial on the parts' shares of the sources (drawn from
``destination_seed`` after the destination side, so every part draws the same
split), and a part draws its ``K_j`` share of sources uniformly in its range
from a stream of ``(seed, part, parts)``.  That is the law of ``generate``:
an edge's source is uniform over all sources, a duplicate pair can only lie
within one part, and the greedy load sums over the parts.  A part's load
comes back in 2^-32 fixed point, so the parts' loads add exactly in any
order, and ``budget`` turns their sum into ``b``.
"""

from __future__ import annotations

import hashlib

import torch

FIXED = 2.0 ** 32  # the fixed point of the loads: integers of 2^-32


def _fixed_sum_by_key(keys: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of ``vals`` (float64, each sum below 2^31) per key in ``[0, n)`` as int64 integers of 2^-32:
    the same bits on every run and in any order (a float sum on the card, or a
    scan, may add in an order that changes from run to run)."""
    fixed = torch.round(vals * FIXED).to(torch.int64)
    return torch.zeros(n, dtype=torch.int64, device=vals.device).index_add_(0, keys, fixed)


def _lognormal(n, mean, std, gen, dev):
    return torch.empty(n, dtype=torch.float64, device=dev).log_normal_(mean, std, generator=gen)


def destination_side(params: dict, device):
    """(scale, value, counts, rho, generator): the destination side from
    ``destination_seed``, and that generator after it."""
    dev = torch.device(device)
    n_src, n_dst = int(params["num_sources"]), int(params["num_destinations"])
    g_dst = torch.Generator(device=dev).manual_seed(int(params["destination_seed"]))
    breadth = _lognormal(n_dst, 0.0, 1.0, g_dst, dev)
    rate = breadth / breadth.sum() * (float(params["target_sparsity"]) * n_dst) * n_src
    scale = _lognormal(n_dst, 0.0, 1.0, g_dst, dev)
    value = _lognormal(n_dst, -4.0, 0.75, g_dst, dev)
    counts = torch.clamp_max(torch.poisson(rate, generator=g_dst), n_src).to(torch.int64)
    rho = 0.5 + 0.5 * torch.rand(n_dst, dtype=torch.float64, device=dev, generator=g_dst)
    return scale, value, counts, rho, g_dst


def part_bounds(n: int, part: int, parts: int):
    """The sources ``[lo, hi)`` of ``part`` of ``parts``."""
    return part * n // parts, (part + 1) * n // parts


def part_counts(params: dict, device, parts: int) -> torch.Tensor:
    """(parts, n_dst) int64: each destination's ``K_j`` split over the parts
    by a multinomial on their shares of the sources, as sequential binomials
    drawn from ``destination_seed``'s generator after the destination side."""
    _, _, counts, _, g_dst = destination_side(params, device)
    return _split(counts, g_dst, int(params["num_sources"]), parts)


def _split(counts, g_dst, n_src, parts):
    left, out = counts.to(torch.float64), []
    for part in range(parts - 1):
        lo, hi = part_bounds(n_src, part, parts)
        share = torch.full_like(left, (hi - lo) / (n_src - lo))
        out.append(torch.binomial(left, share, generator=g_dst).to(torch.int64))
        left = left - out[-1]
    out.append(left.to(torch.int64))
    return torch.stack(out)


def _edges(counts, n_src, scale, value, g, dev):
    """A (n_src columns) block: its CSC arrays, ``a`` and ``c`` in float64
    (``c`` before its sign), and the greedy load per destination in fixed
    point."""
    n_dst = counts.numel()
    affinity = _lognormal(n_src, 0.0, 0.5, g, dev)
    dest = torch.repeat_interleave(torch.arange(n_dst, device=dev), counts)
    key = dest * n_src + torch.randint(0, n_src, (dest.numel(),), generator=g, device=dev)
    del dest
    key = torch.unique(key, sorted=True)  # destination-major, as the upstream dedupe leaves it
    dest, src = key // n_src, key % n_src
    del key
    c = torch.clamp_max(value[dest] * affinity[src] * _lognormal(dest.numel(), 0.0, 0.5, g, dev), 0.5)
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

    best_a = torch.full((n_src,), -torch.inf, dtype=torch.float64, device=dev).scatter_reduce_(0, src, a, "amax")
    pos = torch.nonzero(a == best_a[src]).flatten()
    first = torch.full((n_src,), a.numel(), dtype=torch.int64, device=dev).scatter_reduce_(0, src[pos], pos, "amin")
    first = first[first < a.numel()]
    return indptr, rows, a, c, _fixed_sum_by_key(rows[first], a[first], n_dst)


def generate(params: dict, seed: int, device) -> dict:
    """The CSC arrays on ``device``: ``indptr`` (n+1,) int64, ``rows`` (nnz,)
    int32, ``a`` and ``c`` (nnz,) float32, ``b`` (m,) float32."""
    dev = torch.device(device)
    scale, value, counts, rho, _ = destination_side(params, dev)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    indptr, rows, a, c, load = _edges(counts, int(params["num_sources"]), scale, value, g, dev)
    b = rho * (load.to(torch.float64) / FIXED + 1e-8)
    return {"indptr": indptr, "rows": rows.to(torch.int32), "a": a.to(torch.float32),
            "c": (-c).to(torch.float32), "b": b.to(torch.float32)}


def part_seed(seed: int, part: int, parts: int) -> int:
    """The source side's seed of one part: a hash of ``(seed, part, parts)``."""
    digest = hashlib.sha256(f"{int(seed)}:{part}:{parts}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generate_part(params: dict, seed: int, device, part: int, parts: int) -> dict:
    """Part ``part`` of ``parts`` on ``device``: the CSC arrays of the sources
    ``part_bounds(num_sources, part, parts)`` (``indptr`` from 0, ``rows``
    global), and ``load`` (n_dst,) int64, the part's greedy load in 2^-32
    fixed point; ``budget`` of the parts' summed loads is ``b``."""
    dev = torch.device(device)
    lo, hi = part_bounds(int(params["num_sources"]), part, parts)
    scale, value, counts, _, g_dst = destination_side(params, dev)
    counts = _split(counts, g_dst, int(params["num_sources"]), parts)[part]
    g = torch.Generator(device=dev).manual_seed(part_seed(seed, part, parts))
    indptr, rows, a, c, load = _edges(counts, hi - lo, scale, value, g, dev)
    return {"indptr": indptr, "rows": rows.to(torch.int32), "a": a.to(torch.float32),
            "c": (-c).to(torch.float32), "load": load}


def budget(params: dict, load: torch.Tensor, device) -> torch.Tensor:
    """``b`` (n_dst,) float32 from the summed fixed-point load, as ``generate`` makes it."""
    _, _, _, rho, _ = destination_side(params, device)
    return (rho * (load.to(device=rho.device, dtype=torch.float64) / FIXED + 1e-8)).to(torch.float32)
