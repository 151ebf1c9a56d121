"""The port's cross-rank reducer (`utils/hostsync.py`) in real gloo jobs
on the CPU, the cases of tests/test_hostsync.py that still apply: the max
(and sum) over ranks, tags issued in order, many ranks with the
reductions on a thread beside the main thread's all-reduces on another
group, a tag issued out of order, and a lost peer that fails the
survivor at once rather than hanging.  Each rank is a process running
tests/torch_dist_workers.py, joined through a file:// rendezvous."""

import os
import pickle
import subprocess
import sys

import pytest

from test_torch_cli import subprocess_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_dist_workers.py")


def sync_job(tmp_path, case, world):
    """Every rank's results of `case`; each rank exits within 120 s."""
    init = "file://" + str(tmp_path / "rendezvous")
    outs = [str(tmp_path / "rank{}.pickle".format(r)) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKERS, "sync", case, init, str(r), str(world),
         outs[r]], cwd=REPO, env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    res = []
    for p, log, out in zip(procs, logs, outs):
        assert p.returncode == 0, log[-3000:]
        with open(out, "rb") as fh:
            res.append(pickle.load(fh))
    return res


@pytest.mark.parametrize("world", [2, 3])
def test_max_and_total_over_ranks(tmp_path, world):
    res = sync_job(tmp_path, "max", world)
    assert [r["max"] for r in res] == [512] * world
    assert [r["total"] for r in res] == [world * (world + 1) // 2] * world


def test_sequence_of_tags(tmp_path):
    res = sync_job(tmp_path, "tags", 2)
    assert [r["max"] for r in res] == [[5, 700, 900, 128]] * 2


def test_thread_beside_the_gradient_group(tmp_path):
    """Three ranks reduce on a thread while their main threads all-reduce
    on the gradient group, each rank's two streams interleaved at its own
    pace: no deadlock, and every tag's max."""
    res = sync_job(tmp_path, "thread", 3)
    assert all(not r["alive"] for r in res)
    assert [r["max"] for r in res] == [[20 + i for i in range(20)]] * 3


def test_tags_out_of_order_raise(tmp_path):
    res = sync_job(tmp_path, "mismatch", 2)
    assert all("tag mismatch" in r["error"] for r in res)


def test_lost_peer_fails_fast(tmp_path):
    """Rank 1 dies after one reduction: rank 0's next reduction raises
    within seconds (gloo's connection breaks, well before the group's 60
    s timeout), and the one after raises at once."""
    (r0,) = sync_job(tmp_path, "lost", 2)[:1]
    assert "peer" in r0["error"] and r0["seconds"] < 20
    assert "peer" in r0["again"][0] and r0["again"][1] < 1
