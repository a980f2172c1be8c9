"""The CPU tests run torch on one intra-op thread a process.

pytest-xdist runs the suite in several worker processes at once (``-n 6`` on an 8-core
host). torch's default of one intra-op thread per core then puts about six times as many
busy threads as there are cores, and its OpenMP workers spin while they wait for one
another: the port's CPU tests (tests/test_torch_*.py) took 483 s of wall under ``-n 6
--dist loadfile`` on an 8-core host with the default, and 197 s with one thread a process
(their test seconds summed: 2561 and 918), no test failing either way. Every worker
imports every test module while it collects, before it runs any test, so setting the count
here holds for all of them, and for a run without xdist.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
