"""Faults planted underneath the timed path, for the check's tests: each
patches the port in the process that applies it."""
from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def apply(fault: str, setattr=setattr) -> None:
    """Plant ``fault``; ``setattr`` (a test's monkeypatch.setattr, which
    undoes it) sets each patched attribute."""
    from altro_tpu_torch import mpc

    start_from = mpc._StepPieces.start_from
    finish = mpc._Pieces.finish

    def stash_start(self, carry, *rest):
        self._stash = carry[:4]
        return start_from(self, carry, *rest)

    def faulty_finish(self, prob_k, state, x0_new):
        carry, out = finish(self, prob_k, state, x0_new)
        x0, X, U, duals = self._stash
        if fault == "state_unchanged":
            # the step hands back the state it was given, as solved
            out = mpc.MPCResults(X=X, U=U, iters=torch.zeros_like(out.iters),
                                 status=torch.ones_like(out.status),
                                 viol=torch.zeros_like(out.viol), x0=x0)
            return (x0, X, U, duals), out
        if fault == "half_batch":
            # the second half of the lanes is never solved
            h = out.U.shape[0] // 2
            out.U[h:], out.X[h:] = U[h:], X[h:]
        elif fault == "answer_altered":
            out.U[:, 0] += 0.05 * (1.0 + out.U[:, 0].abs())
        return (carry[0], out.X, out.U) + tuple(carry[3:]), out

    setattr(mpc._StepPieces, "start_from", stash_start)
    setattr(mpc._Pieces, "finish", faulty_finish)
