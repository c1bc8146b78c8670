"""The test suite's one thread policy: one intra-op thread a process.

The suite runs under pytest-xdist, six workers at once on one machine.
torch's intra-op pool defaults to every core, so six workers start six
pools of that size over the same cores, and the port's CPU tests (batches
of tens to about a thousand rows through the plain versions) gain nothing
from them: the pools only contend.  Six processes each building a 60-kbp
`Mapper` and streaming five 32-pair batches took about 111 s a process at
8 threads on an 8-core machine, and 1.0-1.2 s at one; six of the port's
mapper test files fell from 738 to 341 worker-seconds.

pytest loads this file before any test module, and nothing before it
imports torch, so the variable alone sets the pool; the explicit call
covers a session in which a plugin imported torch first.  Subprocesses a
test starts (gloo ranks, reference runs) build their environment from
``os.environ`` and so inherit the variable.  ``setdefault``: a value set
by whoever runs the suite wins.
"""
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")
if "torch" in sys.modules:
    sys.modules["torch"].set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
