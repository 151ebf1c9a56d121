"""The port's data-parallel training and sharded basecalling on the CPU.

- The gradient step of a 2-rank gloo job (two processes,
  tests/torch_dist_workers.py, a file:// rendezvous in tmp_path) against
  the JAX mesh step over 2 of the suite's 8 CPU devices
  (`train.jit_grad_step` / `jit_train_step` / `jit_apply_step` with a
  mesh), the same seeded global batch split in two halves: every rank
  valid, rank 1 padded with `_pad_batch` rows (a wrong divisor shows),
  and two sub-batches accumulated.  Also against the port's one-process
  step on the whole batch, and every rank against the other.
- `cli.train_flipflop --multihost --seqlen_buckets` in two processes
  (size 16, 3 iterations): both finish, only the lead writes the outdir;
  in a job of one rank, batch.log byte for byte the plain run's.
- The sharded `Basecaller` on [cpu, cpu] against [cpu], and the CLI with
  --ndevices 2 against bin/basecall.py --ndevices 1.

Tolerances: loss 1e-5 relative; each gradient, grad_maxs and updated
parameter 1e-5 of its tensor's largest value, against JAX (f32 through
the recurrent layers and the lattice in another order; Adam's step at a
warmup rate of 1e-4 moves a parameter by at most 1e-4) and against the
port's one-process step (the same arithmetic, the batch's sums taken in
two halves); the two ranks bitwise."""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taiyaki_tpu import train as jtrain
from taiyaki_tpu.data import chunk_selection as jcs
from taiyaki_tpu.data import mapped_signal_files as jmsf
from taiyaki_tpu.models import mLstm_flipflop as jmodel
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.cli import basecall
from taiyaki_tpu_torch.parallel import mesh as tmesh
# one_torch_thread is an autouse fixture, calls a shared basecall run
from test_torch_cli import (  # noqa: F401
    CHUNK, OVERLAP, calls, one_torch_thread, read_calls, shared_run,
    subprocess_env)
# trained: both training CLIs' shared run on mLstm_flipflop
from test_torch_train import CLI_ARGS as TRAIN_CLI_ARGS  # noqa: E402
from test_torch_train import trained  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = os.path.join(REPO, "RESULTS", "training_ingredients",
                     "mapped_remap_samref.hdf5")
WORKERS = os.path.join(REPO, "tests", "torch_dist_workers.py")
PORT_MODEL = os.path.join(REPO, "taiyaki_tpu_torch", "models",
                          "mLstm_flipflop.py")
KWARGS = dict(insize=1, size=16, winlen=19, stride=5)
N = 4                 # rows a rank
LR0 = 1e-4


def free_port():
    """An ephemeral port for a tcp:// rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args_of, world, timeout=300):
    """`world` processes, rank r running tests/torch_dist_workers.py with
    args_of(r); each must exit 0 within `timeout` seconds."""
    procs = [subprocess.Popen([sys.executable, WORKERS] + args_of(r),
                              cwd=REPO, env=subprocess_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def global_batch(seed, npad):
    """2N chunks from the repo's reads drawn by the JAX sampler; the last
    `npad` rows of rank 1's half are `_pad_batch` rows (the last real row
    again, seqlens 0)."""
    with jmsf.MappedSignalReader(READS) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = jcs.sample_filter_parameters(reads, 50, 500, 3.0, 10.0, 0.5, 5, 1.1)
    b, _ = jtrain.sample_batch(reads, 500, 2 * N,
                               jtrain.max_seqlen_for_chunk(500, 5), alphabet,
                               fp, seqlen_granularity=128)
    assert b.signal.shape[1] == 2 * N
    signal, seqs, seqlens = b.signal.copy(), b.seqs.copy(), b.seqlens.copy()
    last = 2 * N - npad - 1
    for i in range(2 * N - npad, 2 * N):
        signal[:, i], seqs[i], seqlens[i] = signal[:, last], seqs[last], 0
    return signal, seqs, seqlens


def halves(batch):
    signal, seqs, seqlens = batch
    return [(signal[:, r * N:(r + 1) * N], seqs[r * N:(r + 1) * N],
             seqlens[r * N:(r + 1) * N], None) for r in range(2)]


CASES = {"every row valid": ([(1, 0)], False),
         "rank 1 padded": ([(2, 3)], False),
         "two sub-batches": ([(3, 0), (4, 2)], True)}


def _threshs(nleaf):
    t = np.full(nleaf, np.inf, np.float32)
    t[0] = 1e-3                           # clip one tensor
    return t


def _run_job(d):
    jnet = jmodel.network(size=16, stride=5, winlen=19)
    params = jnet.init(np.random.default_rng(11))
    nleaf = len(jax.tree.leaves(params))
    cases = {}
    for name, (draws, give_nvalid) in CASES.items():
        batches = [global_batch(*draw) for draw in draws]
        case = dict(lr0=LR0, threshs=_threshs(nleaf), global_batches=batches,
                    batches=[[halves(b)[r] for b in batches]
                             for r in range(2)])
        if give_nvalid:               # as the CLI's sampler gives it
            case["nvalid"] = [int((b[2] > 0).sum()) for b in batches]
        cases[name] = case
    spec = dict(model=PORT_MODEL, kwargs=KWARGS, params=params, cases=cases)
    inp = str(d / "spec.pickle")
    with open(inp, "wb") as fh:
        pickle.dump(spec, fh)
    init = "file://" + str(d / "rendezvous")
    run_ranks(lambda r: ["step", inp, init, str(r), "2",
                         str(d / "rank{}.pickle".format(r))], 2)
    out = []
    for r in range(2):
        with open(str(d / "rank{}.pickle".format(r)), "rb") as fh:
            out.append(pickle.load(fh))
    return spec, out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 2-rank job's results on every case (one run, shared by the
    workers)."""
    return shared_run(tmp_path_factory, "torch_dp_step", _run_job)


def _jax_mesh_case(jnet, params, case):
    """The JAX mesh step's losses, summed gradients, grad_maxs and
    parameters on the case's global batches."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("data",))
    opt, _ = jtrain.make_optimizer(4e-3, 10, 2, case["lr0"], 1e-4)
    threshs = jnp.asarray(case["threshs"])
    batches = [jtrain.shard_batch(jtrain.Batch(*b, None), mesh)
               for b in case["global_batches"]]
    gstep = jtrain.jit_grad_step(jtrain.make_grad_step(jnet), mesh)
    losses, acc = [], None
    for b in batches:
        loss, grads = gstep(params, b, 1.0, 1.0)
        losses.append(float(loss))
        acc = jtrain.accumulate_grads(acc, grads)
    grads = [np.asarray(g) for g in jax.tree.leaves(acc)]
    if len(batches) == 1:
        step = jtrain.jit_train_step(jtrain.make_train_step(jnet, opt), mesh)
        new_params, _, loss, maxs = step(params, opt.init(params),
                                         batches[0], 1.0, 1.0, threshs)
        assert float(loss) == pytest.approx(losses[0], rel=1e-6)
    else:
        astep = jtrain.jit_apply_step(jtrain.make_apply_step(opt), mesh)
        new_params, _, maxs = astep(params, opt.init(params), acc,
                                    float(len(batches)), threshs)
    return dict(losses=losses, grads=grads, maxs=np.asarray(maxs),
                params=[np.asarray(p) for p in jax.tree.leaves(new_params)])


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.abs(np.asarray(g) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (what, i, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_step_matches_jax_mesh_step(job, name):
    """Loss, gradients (summed over the sub-batches), grad_maxs and the
    parameters after the update, rank 0 against the JAX mesh step on 2
    devices; rank 1 bitwise rank 0 (replicas stay identical)."""
    spec, (r0, r1) = job
    case = spec["cases"][name]
    jnet = jmodel.network(size=16, stride=5, winlen=19)
    want = _jax_mesh_case(jnet, spec["params"], case)
    got = r0[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    if "step_loss" in got:
        assert got["step_loss"] == got["losses"][0]
    _close(got["grads"], want["grads"], 1e-5, "grad")
    _close([got["maxs"]], [want["maxs"]], 1e-5, "grad_maxs")
    _close(got["params"], want["params"], 1e-5, "param")
    assert r0["backend"] == r1["backend"] == "gloo"
    for key in ("losses", "maxs"):
        np.testing.assert_array_equal(r1[name][key], got[key])
    for key in ("grads", "params"):
        for a, b in zip(r1[name][key], got[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_step_matches_one_process_step(job, name):
    """The same global batches through the port's one-process steps (no
    group): losses, gradients and parameters within 1e-5."""
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    spec, (r0, _) = job
    case = spec["cases"][name]
    cpu = torch.device("cpu")

    def net():
        return load_jax_params(helpers.new_model(PORT_MODEL, **KWARGS)[0],
                               spec["params"])

    tnet = net()
    opt, _ = ttrain.make_optimizer(ttrain.leaf_params(tnet), 4e-3, 10, 2,
                                   case["lr0"], 1e-4)
    gstep = ttrain.make_grad_step(tnet)
    losses, acc = [], None
    for b in case["global_batches"]:
        loss, grads = gstep(ttrain.batch_to_device(ttrain.Batch(*b, None),
                                                   cpu), 1.0)
        losses.append(float(loss))
        acc = ttrain.accumulate_grads(acc, grads)
    grads = [g.clone() for g in acc]
    ttrain.make_apply_step(opt)(acc, float(len(losses)), case["threshs"])
    got = r0[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _close(got["grads"], [g.numpy() for g in grads], 1e-5, "grad")
    _close(got["params"], [p.detach().numpy()
                           for p in ttrain.leaf_params(tnet)], 1e-5, "param")


def test_padded_rows_change_the_divisor(job):
    """Rank 1's padded rows count in no rank's divisor: on that case the
    mean of the ranks' own means (what averaging per-rank losses, as DDP
    does, would report) is not the global loss the job reports."""
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    spec, (r0, _) = job
    case = spec["cases"]["rank 1 padded"]
    shares = [b[0] for b in case["batches"]]
    assert [int((h[2] > 0).sum()) for h in shares] == [N, N - 3]
    net = load_jax_params(helpers.new_model(PORT_MODEL, **KWARGS)[0],
                          spec["params"])
    loss_fn = ttrain.make_loss_fn(net)
    with torch.no_grad():
        means = [float(loss_fn(ttrain.batch_to_device(
            ttrain.Batch(*h), torch.device("cpu")), 1.0)) for h in shares]
    got = r0["rank 1 padded"]["losses"][0]
    assert abs(np.mean(means) - got) > 1e-3 * abs(got)


def test_round_batch_to_mesh_matches_jax():
    from taiyaki_tpu.parallel import mesh as jmesh
    jm = jmesh.data_mesh(jax.devices()[:3])
    tm = tmesh.data_mesh([torch.device("cpu")] * 3)
    for n in (1, 2, 3, 4, 7, 128, 341):
        assert tmesh.round_batch_to_mesh(n, tm) == \
            jmesh.round_batch_to_mesh(n, jm)


def test_rendezvous_reads_either_set_of_variables():
    env = {"TAIYAKI_COORDINATOR": "h:1234", "TAIYAKI_NUM_PROCS": "4",
           "TAIYAKI_PROC_ID": "2"}
    assert tmesh.rendezvous(env) == ("tcp://h:1234", 4, 2)
    env = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "RANK": "1",
           "WORLD_SIZE": "2"}
    assert tmesh.rendezvous(env) == ("env://", 2, 1)
    with pytest.raises(ValueError, match="TAIYAKI_COORDINATOR.*MASTER_ADDR"):
        tmesh.rendezvous({"TAIYAKI_COORDINATOR": "h:1"})


# -- the training CLI in two processes ----------------------------------------

CLI_ARGS = ["--device", "cpu", "--multihost", "--seqlen_buckets", "--size",
            "16", "--stride", "2", "--winlen", "9", "--niteration", "3",
            "--warmup_batches", "1", "--chunk_len_min", "300",
            "--chunk_len_max", "400", "--min_sub_batch_size", "8",
            "--save_every", "2", "--sample_nreads_before_filtering", "50",
            "--reporting_sub_batches", "10", "--seed", "13", "--quiet"]


def _train_two(d):
    port = free_port()
    procs, outdirs = [], []
    for rank in range(2):
        outdir = str(d / "rank{}".format(rank))
        env = dict(subprocess_env(), TAIYAKI_COORDINATOR="localhost:{}"
                   .format(port), TAIYAKI_NUM_PROCS="2",
                   TAIYAKI_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "taiyaki_tpu_torch.cli.train_flipflop"]
            + CLI_ARGS + ["--outdir", outdir, PORT_MODEL.replace(
                "mLstm_flipflop", "mGru_flipflop"), READS],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        outdirs.append(outdir)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], logs, outdirs


@pytest.fixture(scope="module")
def trained_two(tmp_path_factory):
    return shared_run(tmp_path_factory, "torch_multihost_cli", _train_two)


def test_cli_two_processes_finish_and_only_the_lead_writes(trained_two):
    rcs, logs, (lead, follower) = trained_two
    assert rcs == [0, 0], [log[-3000:] for log in logs]
    assert not os.path.exists(follower)
    with open(os.path.join(lead, "batch.log")) as fh:
        rows = fh.read().splitlines()
    assert len(rows) == 4
    assert all(np.isfinite(float(r.split("\t")[1])) for r in rows[1:])
    for name in ("model_checkpoint_00001", "model_final"):
        assert os.path.exists(os.path.join(lead, name + ".checkpoint"))
    with open(os.path.join(lead, "model.log")) as fh:
        assert "* Rank 0 of 2 on cpu; gradients all-reduced over gloo" \
            in fh.read()


# -- sharded basecalling ------------------------------------------------------

def test_sharded_basecaller_equals_one_device():
    """Every output of the Basecaller on [cpu, cpu] bitwise [cpu]'s; its
    max_batch rounded down to a multiple of the devices."""
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    net, _, _ = helpers.new_model(PORT_MODEL, **KWARGS)
    net = load_jax_params(net, net.init(np.random.default_rng(3))).eval()
    chunks = np.random.default_rng(0).normal(size=(300, 7, 1)).astype(
        np.float32)
    cpu = torch.device("cpu")
    out = []
    for devices in ([cpu], [cpu, cpu]):
        caller = basecall.Basecaller(net, 40, True, 1.0, 5, devices,
                                     want_errprobs=True, want_trans=True)
        assert caller.max_batch == 5 if len(devices) == 1 else 4
        with torch.inference_mode():
            out.append(caller.gather(caller.submit(chunks)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_cli_ndevices_calls_equal_jax_and_one_device(calls, tmp_path):
    """`cli.basecall --device cpu --ndevices 2` (two replicas) calls what
    bin/basecall.py --ndevices 1 and the port on one device call, byte
    for byte, and says it shards."""
    import contextlib
    import io
    ids, out, model, reads = calls
    path = str(tmp_path / "sharded.fq")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        stats = basecall.main(
            ["--device", "cpu", "--ndevices", "2", "--fastq",
             "--chunk_size", str(CHUNK), "--overlap", str(OVERLAP),
             "--max_concurrent_chunks", "4", "--quiet", "--output", path,
             reads, model])
    assert "Sharding chunk batches over 2 devices" in err.getvalue()
    assert stats["ncalled"] == len(ids)
    got = read_calls(path, fastq=True)
    assert got == out["port"]
    assert {k: v[0] for k, v in got.items()} == \
        {k: v[0] for k, v in out["jax"].items()}


def test_cli_ndevices_past_the_cards_stops():
    """More cards asked for than there are: the JAX CLI's message."""
    have = torch.cuda.device_count()
    with pytest.raises(SystemExit, match="--ndevices {} requested but only "
                       "{} local devices".format(have + 1, have)):
        basecall.select_devices("cuda", have + 1)


def test_cli_one_rank_multihost_equals_plain_run(trained, tmp_path,
                                                 monkeypatch):
    """`--multihost` in a job of one rank (its tcp:// rendezvous from the
    TAIYAKI_* variables): batch.log equal, byte for byte, to the plain
    run's at the same seed and arguments (test_torch_train's CLI run)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    monkeypatch.setenv("TAIYAKI_COORDINATOR",
                       "localhost:{}".format(free_port()))
    monkeypatch.setenv("TAIYAKI_NUM_PROCS", "1")
    monkeypatch.setenv("TAIYAKI_PROC_ID", "0")
    outdir = str(tmp_path / "multihost")
    train_flipflop.main(TRAIN_CLI_ARGS + [
        "--multihost", "--outdir", outdir,
        os.path.join(REPO, "taiyaki_tpu_torch", "models",
                     "mLstm_flipflop.py"), READS])
    logs = []
    for d in (outdir, trained["port"]):
        with open(os.path.join(d, "batch.log")) as fh:
            logs.append(fh.read())
    assert logs[0] == logs[1]
