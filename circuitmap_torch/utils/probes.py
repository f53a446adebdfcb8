"""Hang-proof subprocess probes, shared by the operations commands
(port of ``circuitmap_tpu/utils/probes.py``, host-only).

A wedged driver or a card that has fallen off the bus can block a CUDA
call forever, so every environment and hardware check (``doctor``,
``hw-smoke``) runs in a fresh interpreter with a timeout: the parent
stays responsive, and a wedged probe cannot poison the next one's CUDA
context. This module is the one copy of that contract: timeout
handling, exit-code diagnosis, and the stderr-tail format both commands
print.
"""

from __future__ import annotations

import subprocess


def run_probe_cmd(cmd, timeout, cwd=None):
    """Run ``cmd`` (argv list) with a hard timeout.

    Returns ``(stdout, err)`` where ``err`` is ``None`` on rc==0,
    else a short diagnosis ("timeout after Ns" or the stderr tail —
    stderr can interleave arbitrarily with library logging, so callers
    must scan stdout for marker lines rather than trusting the last
    line).
    """
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=cwd)
    except subprocess.TimeoutExpired:
        return "", "timeout after %.0fs" % timeout
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip()[-400:]
        return proc.stdout or "", "exit %d: %s" % (proc.returncode, tail)
    return proc.stdout, None
