"""Faults planted under the timed path, for the readings that set the limits (portbench/control.py --fault) and for
the tests that see ``correct`` come out false. A fault wraps the program's serving call or its train step; the
benchmark's own runs never plant one.

Serving (a wrapper of ``serve(frames1, frames2) -> outputs``):
    answer_altered   one pair's answer altered where it is produced: row 0 takes row 1's pointmap
    half_batch       half of the batch left out: the second half answered with the first half's outputs
    stale            the state left unchanged: every batch answered with the first batch's outputs
Training (a change of the program's ``TrainContext``):
    state_unchanged  the step computes its loss and gradients and skips the update
    half_batch_mean  half of the batch left out of the loss, the mean taken over the rest
"""

__all__ = ["SERVING", "TRAINING"]


def answer_altered(serve):
    def broken(f1, f2):
        out = list(serve(f1, f2))
        out[0] = out[0].clone()
        out[0][0] = out[0][1]
        return tuple(out)

    return broken


def half_batch(serve):
    import torch

    def broken(f1, f2):
        h = len(f1) // 2
        out = serve(f1[:h], f2[:h])
        return tuple(torch.cat([o, o]) for o in out)

    return broken


def stale(serve):
    first = []

    def broken(f1, f2):
        if not first:
            first.append(serve(f1, f2))
        return first[0]

    return broken


def state_unchanged(trainer):
    trainer._update = lambda grads: None
    return trainer


def half_batch_mean(trainer):
    loss_fn = trainer.loss_fn

    def half(m, img1, img2, t1, t2):
        h = len(img1) // 2
        return loss_fn(m, img1[:h], img2[:h], t1[:h], t2[:h])

    trainer.loss_fn = half
    return trainer


SERVING = {"answer_altered": answer_altered, "half_batch": half_batch, "stale": stale}
TRAINING = {"state_unchanged": state_unchanged, "half_batch_mean": half_batch_mean}
