"""Faults planted in the program's timed path, for the tests of the
comparison and the fault readings of ``control.py``.  Each wraps an entry
the drivers build from the program (``training/step.py::make_train_step``,
``make_streaming_eval_fns``) while ``planted`` is open, so a run drives
the fault through the window's own calls; the drivers know nothing of it.

* train, "half_batch": each step gets the first half of its batch only;
* train, "unchanged": each step's update of the model is undone;
* eval, "altered": the first frame of each batch is moved by 5 cm;
* eval, "half_batch": the second half of each batch gets the first half's
  poses.
"""

from __future__ import annotations

import contextlib
from typing import Dict

TRAIN = ("half_batch", "unchanged")
EVAL = ("altered", "half_batch")


def train_step(step, fault: str):
    """``step`` with ``fault`` planted."""

    def faulty(state, batch, generator, stage=None):
        if fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        snapshot = {n: t.detach().clone() for n, t in state.model.state_dict().items()} \
            if fault == "unchanged" else None
        state, metrics = step(state, batch, generator, stage=stage)
        if snapshot is not None:
            state.model.load_state_dict(snapshot)
        return state, metrics

    return faulty


def poses(out: Dict, fault: str) -> Dict:
    """The correlate step's output ``out`` with ``fault`` planted."""
    if fault == "altered":
        t = out["t"].clone()
        t[0] += 0.05
        return {"q": out["q"], "t": t}
    if fault == "half_batch":
        h = out["q"].shape[0] // 2
        return {k: v[:h].repeat(2, 1) for k, v in out.items()}
    return out


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """While open, the program's step factories for ``kind`` ("train" or
    "eval") build steps with ``fault`` planted."""
    from efficientlo_net_torch.training import step as S

    if fault not in {"train": TRAIN, "eval": EVAL}[kind]:
        raise ValueError(f"no fault {fault!r} for {kind}")
    name = "make_train_step" if kind == "train" else "make_streaming_eval_fns"
    make = getattr(S, name)

    def make_train_step(*args, **kwargs):
        return train_step(make(*args, **kwargs), fault)

    def make_streaming_eval_fns(*args, **kwargs):
        encode, correlate = make(*args, **kwargs)
        return encode, lambda *a: poses(correlate(*a), fault)

    setattr(S, name, make_train_step if kind == "train" else make_streaming_eval_fns)
    try:
        yield
    finally:
        setattr(S, name, make)
