"""Port: ``python -m recbole_gnn_tpu_torch.run --distributed`` in two
processes (the counterpart of
``tests/test_parallel.py::test_two_process_distributed_smoke``).

The two ranks meet through ``torchrun``'s environment (``MASTER_ADDR``
127.0.0.1, a free port, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) on gloo
(``--use_gpu=False``) with ``--mesh_shape=[1,2]``: the tp axis spans the
two processes, so the pad-to-shard row-sharded tables (1,005 items),
the edge-sharded graph over tp and the item-sharded evaluation all cross
them.  Both ranks exit 0 and log the same test result, equal (rtol
1e-5) to the single-process run's; only rank 0 logs the run and writes
the checkpoint.
"""

import ast
import os
import re
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "test_data")
FLAGS = ("-m", "LightGCN", "-d", "test", f"--data_path={DATA}",
         "--epochs=1", "--use_gpu=False", "--embedding_size=16",
         "--n_layers=2", "--enable_sparse=True", "--train_batch_size=512",
         "--eval_batch_size=256")


def _run(args, env, ckpt):
    return subprocess.Popen(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run", *FLAGS,
         f"--checkpoint_dir={ckpt}", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _result(out: str) -> dict:
    m = re.search(r"test result: ({.*})", out)
    assert m, out[-3000:]
    return ast.literal_eval(m.group(1))


def test_run_distributed_two_processes(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE="2")
    procs = [_run(["--distributed", "--mesh_shape=[1,2]",
                   "--graph_edge_sharding=True",
                   "--graph_edge_sharding_axis=tp"],
                  dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                  tmp_path / "dist") for r in range(2)]
    single = _run([], dict(os.environ, OMP_NUM_THREADS="1"),
                  tmp_path / "single")
    outs = [p.communicate(timeout=240)[0] for p in procs + [single]]
    for i, (p, out) in enumerate(zip(procs + [single], outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-3000:]}"
    r0, r1, want = (_result(o) for o in outs)
    assert re.search(r"test result: .*", outs[0]).group(0) == \
        re.search(r"test result: .*", outs[1]).group(0)
    assert "recall@10" in want and r0.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(r0[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    # rank 0 alone logs the run and writes the checkpoint
    assert "train loss" in outs[0] and "train loss" not in outs[1]
    assert (tmp_path / "dist" / "LightGCN-test.ckpt").is_file()
