"""Device ms a step of the banded attention's kernels (``kernels/
banded_attention.py``: the relative term, the forward and the backward),
in the phase traced with host ops. None where the trace holds no such
kernel, or where it holds another count of forward kernels than the
program's launch counter gives for the phase's steps."""

import sys

from portbench.kernels import banded_attention


def read(run):
    phase = run.phase("ops")
    if phase is None or not phase.counts["steps"]:
        return None
    seconds, _ = phase.trace.kernel_s(banded_attention.NAMES)
    traced = phase.trace.count(banded_attention.CALL)
    counted = phase.counts.get("attention_launches")
    if not seconds or traced != counted:
        print(f"attention_ms.w2a: {traced} forward kernels traced, "
              f"{counted} launches counted", file=sys.stderr)
        return None
    return 1e3 * seconds / phase.counts["steps"]
