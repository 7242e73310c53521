"""Device ms a step of the backward phases of the port's own step account
(``articulatory_tpu_torch/trace.py``): ``generator_backward`` and
``discriminator_backward``, the gradients' all-reduces among them, over the
untraced phase's steps. Each phase's device ms runs from the event before it
to the event after it on the stream, so it holds the phase's device work and
the time the device waited for its launches. None where the port keeps no
such account."""

PHASES = ("generator_backward", "discriminator_backward")


def read(run):
    try:
        from articulatory_tpu_torch import trace
    except ImportError:
        return None
    phase = run.phase("host")
    if phase is None:
        return None
    lo = run.cell.traffic["warm_steps"]
    return trace.mean_ms(trace.steps(lo, lo + phase.counts["steps"]).values(),
                         PHASES)
