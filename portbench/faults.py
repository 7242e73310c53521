"""Faults planted under a cell's timed path, for the output check's tests
and for ``calibrate.py --fault``: each plants itself in the port's modules
and returns a function that takes it out again.

Decode (under ``inference.py``'s chunk step): ``carry_unchanged`` (the AR
carry never moves), ``half_batch`` (the second half of the lanes' outputs
left at zero), ``answer_altered`` (one sample of each chunk off by 1e-2).
Training (under ``train/gan.py``): ``state_unchanged`` (no optimizer
step), ``half_train_batch`` (both losses over the first half of the rows
only), ``loss_altered`` (the generator's loss 1 % high).
"""

from __future__ import annotations


def _swap(module, name: str, new):
    old = getattr(module, name)
    setattr(module, name, new(old))
    return lambda: setattr(module, name, old)


def _chunk_fault(change):
    from articulatory_tpu_torch import inference

    def wrap(step):
        def broken(forward, cin, prev, ck, mask=None):
            out, new = step(forward, cin, prev, ck, mask)
            return change(out, new, prev)
        return broken
    return _swap(inference, "chunk_step", wrap)


def carry_unchanged():
    return _chunk_fault(lambda out, new, prev: (out, prev))


def half_batch():
    def change(out, new, prev):
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, new
    return _chunk_fault(change)


def answer_altered():
    def change(out, new, prev):
        out = out.clone()
        out[0, out.shape[1] // 2] += 1e-2
        return out, new
    return _chunk_fault(change)


def state_unchanged():
    from articulatory_tpu_torch.train import optimizers
    return _swap(optimizers.Optimizer, "step",
                 lambda old: lambda self, lr: None)


def _half(batch: dict) -> dict:
    h = batch["y"].shape[0] // 2
    return {"x": tuple(x[:h] for x in batch["x"]), "y": batch["y"][:h],
            "ar": batch["ar"][:h]}


def half_train_batch():
    from articulatory_tpu_torch.train import gan
    undo = [_swap(gan, "generator_loss", lambda old: lambda s, c, cfg, b:
                  old(s, c, cfg, _half(b))),
            _swap(gan, "discriminator_loss",
                  lambda old: lambda s, c, cfg, b, y_:
                  old(s, c, cfg, _half(b), y_[:len(_half(b)["y"])]))]
    return lambda: [u() for u in undo]


def loss_altered():
    from articulatory_tpu_torch.train import gan

    def wrap(old):
        def broken(*args):
            loss, metrics = old(*args)
            metrics["train/generator_loss"] = loss * 1.01
            return loss * 1.01, metrics
        return broken
    return _swap(gan, "generator_loss", wrap)


DECODE = {"carry_unchanged": carry_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
TRAIN = {"state_unchanged": state_unchanged,
         "half_train_batch": half_train_batch, "loss_altered": loss_altered}
