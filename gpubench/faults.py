"""Faults planted in the program underneath a run, which the check has to
catch: the CPU tests plant them at a tiny size, and ``control.py`` reads them
on the card at a cell's own size.

Each fault takes ``setattr(target, name, value)`` (pytest's
``monkeypatch.setattr``, or ``planted``'s own) and patches the program with it:

* ``unchanged_state``: every AGD step returns its state unchanged;
* ``half_the_batch``: the row sums over half the nonzeros, doubled, so the
  mean over the rest (csc: the segment-sum's input; butterfly: a*x carried
  back to rows);
* ``altered_answer``: one entry of each returned dual altered where
  ``maximize`` produces it;
* ``lost_rank_part`` (``RANK_FAULTS``: a sharded run's only): rank 0's
  part (grad, obj, reg) zeroed before ``reduce_parts`` sums the ranks'
  parts, so the exchange leaves one rank's columns out (rank 0's: the last
  rank's slice of a tiny problem can be all padding).

A multi-card run plants the fault in every rank.
"""

from __future__ import annotations

import contextlib

import torch


def unchanged_state(setattr):
    from dualip_tpu_torch.optimizers import agd

    make_step = agd.AcceleratedGradientDescent._make_step

    def frozen(self, *args, **kwargs):
        step = make_step(self, *args, **kwargs)
        return lambda params, carry, it, beta: (carry, step(params, carry, it, beta)[1])

    setattr(agd.AcceleratedGradientDescent, "_make_step", frozen)


def half_the_batch(setattr):
    import dualip_tpu_torch.objectives.matching as matching

    def halved(values):
        kept = values.clone()
        kept[values.numel() // 2:] = 0
        return 2 * kept

    seg, carry = matching.segment_sum_rows, matching._carry
    setattr(matching, "segment_sum_rows", lambda out, values, plan: seg(out, halved(values), plan))
    setattr(matching, "_carry", lambda rl, vec, reverse, truncate=True: (
        halved(carry(rl, vec, reverse, truncate)) if reverse else carry(rl, vec, reverse, truncate)))


def altered_answer(setattr):
    from dualip_tpu_torch.optimizers import agd

    maximize = agd.AcceleratedGradientDescent.maximize

    def altered(self, *args, **kwargs):
        res = maximize(self, *args, **kwargs)
        res.dual_val = res.dual_val.clone()
        i = int(torch.argmax(res.dual_val))
        res.dual_val[i] = 2 * res.dual_val[i] + 1e-3
        return res

    setattr(agd.AcceleratedGradientDescent, "maximize", altered)


def lost_rank_part(setattr):
    import dualip_tpu_torch.objectives.matching as matching

    reduce_parts = matching.reduce_parts

    def lost(mesh, grad, dual_obj, reg):
        if mesh.rank == 0:
            grad, dual_obj, reg = torch.zeros_like(grad), torch.zeros_like(dual_obj), torch.zeros_like(reg)
        return reduce_parts(mesh, grad, dual_obj, reg)

    setattr(matching, "reduce_parts", lost)


FAULTS = {f.__name__: f for f in (unchanged_state, half_the_batch, altered_answer)}  # every cell's
RANK_FAULTS = {f.__name__: f for f in (lost_rank_part,)}  # a multi-card cell's
ALL = {**FAULTS, **RANK_FAULTS}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the ``with`` block, undone after it."""
    undo = []

    def patch(target, attr, value):
        undo.append((target, attr, getattr(target, attr)))
        setattr(target, attr, value)

    try:
        ALL[name](patch)
        yield
    finally:
        for target, attr, old in reversed(undo):
            setattr(target, attr, old)
