"""Faults planted under a cell's timed path. Each breaks what the check
guards and has to come out not correct: the tests run them on the CPU at a
tiny size, `calibrate.py --fault` reads them on the card.

A serving fault takes (engine, batcher) and breaks them in place; a
training fault takes the train step and returns a broken one.
"""


def altered_token(engine, batcher):
    """Every sampled token moved to its neighbour where it is produced."""
    orig = engine._sample

    def sample(logits, gen=None):
        return (orig(logits, gen) + 1) % logits.shape[-1]
    engine._sample = sample


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(params, state, batch):
        t = batch["tokens"]
        return step(params, state, {"tokens": t[: t.shape[0] // 2]})
    return broken


def state_unchanged(step):
    """The step returns the parameters it was given."""
    def broken(params, state, batch):
        _, new_state, metrics = step(params, state, batch)
        return params, new_state, metrics
    return broken


FAULTS = {"serve": {"altered_token": altered_token},
          "train": {"half_batch": half_batch,
                    "state_unchanged": state_unchanged}}
