"""The suite's thread policy (tests/conftest.py): one intra-op thread in
every test process, and in every child a test starts the way the gloo
launchers start their ranks."""
import os
import subprocess
import sys

import torch


def test_worker_has_one_intra_op_thread():
    assert torch.get_num_threads() == 1, os.environ.get("OMP_NUM_THREADS")


def test_rank_style_child_has_one_intra_op_thread():
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), os.pardir,
                                      "src")}
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1", out.stdout
