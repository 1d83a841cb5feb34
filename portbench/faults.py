"""Faults of the timed path, each a wrapper of ``models.model.
decode_step`` that ``port.planted`` puts under ``Server.step``: the check
has to read ``correct`` false with any of them.  ``tests/test_planted_faults.py``
plants them in a rehearsed run at a test's size; ``calibrate.py
--faults`` at a cell's own size on the card.  One chip has no exchange
between chips to leave out."""
from typing import Callable, Dict


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def state_unchanged(fn: Callable) -> Callable:
    """The step returns its caches as it found them: no new key, value or
    recurrent state is kept."""
    def step(params, tokens, positions, caches, cfg, backend=None):
        saved = [(t, t.clone()) for t in _leaves(caches)]
        logits, caches = fn(params, tokens, positions, caches, cfg,
                            backend=backend)
        for t, old in saved:
            t.copy_(old)
        return logits, caches
    return step


def token_altered(fn: Callable) -> Callable:
    """Every slot's logits shifted by one id where they are produced."""
    def step(*args, **kw):
        logits, caches = fn(*args, **kw)
        return logits.roll(1, dims=-1), caches
    return step


def half_batch_left_out(fn: Callable) -> Callable:
    """Every other slot's row left out of the step: it gets the logits of
    the slot before it.  Half of the batch wherever the live requests sit
    (the server fills the lowest free slots first)."""
    def step(*args, **kw):
        logits, caches = fn(*args, **kw)
        logits = logits.clone()
        odd = logits[1::2].shape[0]
        logits[1::2] = logits[0:2 * odd:2]
        return logits, caches
    return step


FAULTS: Dict[str, Callable] = {f.__name__: f for f in (
    state_unchanged, token_altered, half_batch_left_out)}
