"""The port's training stack on the CPU against the JAX package: optimizer
schedules against optax, one whole training step of mLstm_flipflop at size
16 against train.make_train_step + optax, the sub-batch path, batch
helpers, the data path on the repo's mapped reads, and the training CLI
against bin/train_flipflop.py (mLstm_flipflop and mGru_flipflop).

Tolerances: schedules 1e-5 relative (optax evaluates them in f32, and its
cosine interpolation end + (start - end) * k cancels digits near lr_min
by up to lr_max / lr_min); loss
1e-5 relative and each gradient 1e-4 of its tensor's largest value (f32
through 5 recurrent layers and the lattice in another order).  Parameters
after one AdamW step: Adam divides by sqrt(v) + eps with eps = 1e-6, so a
gradient difference d moves an update by up to lr * d / eps; the bound is
lr * max|d grad| / eps + 1e-6 * |param| (f32 rounding of the parameter).
The CLI's batch.log losses: 1e-5 relative at the first iteration, then
1e-4 (the same Adam bound carried through later steps)."""

import io
import os
import pickle
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
from taiyaki_tpu.models import mGru_flipflop as jgru_model
from taiyaki_tpu.models import mLstm_flipflop as jmodel
from taiyaki_tpu_torch import train as ttrain
from taiyaki_tpu_torch.convert import leaf_names, load_jax_params
from taiyaki_tpu_torch.data import chunk_selection as tcs
from taiyaki_tpu_torch.data import hdf5
from taiyaki_tpu_torch.data import mapped_signal_files as tmsf
from taiyaki_tpu_torch.models import mGru_flipflop as tgru_model
from taiyaki_tpu_torch.models import mLstm_flipflop as tmodel
# one_torch_thread is an autouse fixture
from test_torch_cli import (  # noqa: F401
    one_torch_thread, shared_run, subprocess_env)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = os.path.join(REPO, "RESULTS", "training_ingredients",
                     "mapped_remap_samref.hdf5")


def _env():
    return subprocess_env(one_jax_device=True)


@pytest.mark.parametrize("warmup,min_momentum", [(3, None), (3, 0.85),
                                                 (0, None)])
def test_schedules_match_optax_over_a_cycle(warmup, min_momentum):
    niter = 12
    opt, sched = jtrain.make_optimizer(4e-3, niter, warmup, 2e-4, 1e-4,
                                       min_momentum=min_momentum)
    lr = ttrain.make_schedule(4e-3, niter, warmup, 2e-4, 1e-4)
    b1 = ttrain.make_b1_schedule(0.9, min_momentum, niter, warmup)
    want_lr = np.array([float(sched(k)) for k in range(niter + 2)])
    np.testing.assert_allclose([lr(k) for k in range(niter + 2)], want_lr,
                               rtol=1e-5)
    if min_momentum is None:
        assert all(b1(k) == 0.9 for k in range(niter))
        return
    p = {"a": jnp.ones(2)}
    state = opt.init(p)
    want_b1 = []
    for _ in range(niter):
        _, state = opt.update({"a": jnp.zeros(2)}, state, p)
        want_b1.append(float(state.hyperparams["b1"]))
    np.testing.assert_allclose([b1(k) for k in range(niter)], want_b1,
                               rtol=1e-5)


def test_batch_helpers_match_jax():
    assert ttrain.chunk_len_buckets(3000, 8000, 5) == \
        jtrain.chunk_len_buckets(3000, 8000, 5)
    assert ttrain.chunk_len_buckets(300, 400, 2, 3) == \
        jtrain.chunk_len_buckets(300, 400, 2, 3)
    for args in ((4000, 5), (8000, 5, 1.2)):
        assert ttrain.max_seqlen_for_chunk(*args) == \
            jtrain.max_seqlen_for_chunk(*args)
    for args in ((300, 728), (1, 728), (700, 728), (300, 728, None)):
        assert ttrain.bucket_seqlen(*args) == jtrain.bucket_seqlen(*args)
    assert ttrain.sub_batch_size_for_chunk(128, 8000, 3000) == \
        jtrain.sub_batch_size_for_chunk(128, 8000, 3000)
    ramp_t, ramp_j = (m.linear_ramp(1.0, 3.0, 4) for m in (ttrain, jtrain))
    assert [ramp_t(i) for i in range(6)] == [ramp_j(i) for i in range(6)]


def test_gradient_capper_matches_jax():
    rng = np.random.default_rng(0)
    caps = (ttrain.GradientCapper(3, 2.0, window=5),
            jtrain.GradientCapper(3, 2.0, window=5))
    for _ in range(8):
        g = rng.uniform(size=3)
        got, want = (c.update(g) for c in caps)
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(caps[0].thresholds).all()
    assert np.isinf(ttrain.GradientCapper(2, None).update([1.0, 2.0])).all()


@pytest.mark.parametrize("reader", ["h5py", "own"])
def test_reads_and_chunks_match_jax(reader, monkeypatch):
    """The port's reader (through h5py, or through data.hdf5 as on a
    machine without h5py) gives the JAX reader's reads in its order, and
    one numpy seed draws the same filter parameters and chunks."""
    if reader == "own":
        monkeypatch.setattr(tmsf, "open_file", hdf5.File)
    with jmsf.MappedSignalReader(READS) as msr:
        jreads = list(msr.reads())
    with tmsf.MappedSignalReader(READS) as msr:
        treads = list(msr.reads())
        assert msr.get_alphabet_information().alphabet == "ACGT"
        assert sorted(msr.get_read_ids()) == sorted(r.read_id for r in jreads)
    assert [r.read_id for r in treads] == [r.read_id for r in jreads]
    for a, b in zip(treads, jreads):
        for k in ("Dacs", "Ref_to_signal", "Reference"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (a.shift_frompA, a.scale_frompA) == (b.shift_frompA,
                                                    b.scale_frompA)
    out = []
    for reads, cs in ((jreads, jcs), (treads, tcs)):
        np.random.seed(3)
        fp = cs.sample_filter_parameters(reads, 50, 4000, 3.0, 10.0, 0.5, 5,
                                         1.1)
        chunks, rej = cs.sample_chunks(reads, 12, 4000, fp)
        out.append((tuple(fp), dict(rej), chunks))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    assert len(out[0][2]) == len(out[1][2]) == 12
    for a, b in zip(out[0][2], out[1][2]):
        assert (a.read_id, a.start_sample) == (b.read_id, b.start_sample)
        np.testing.assert_array_equal(a.current, b.current)
        np.testing.assert_array_equal(a.sequence, b.sequence)


def _batch(seed, n=6, chunk_len=500):
    """One seeded batch from the repo's reads, drawn by the JAX package's
    sampler (the port's is held equal to it above)."""
    with jmsf.MappedSignalReader(READS) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = jcs.sample_filter_parameters(reads, 50, chunk_len, 3.0, 10.0, 0.5,
                                      5, 1.1)
    batch, _ = jtrain.sample_batch(reads, chunk_len, n,
                                   jtrain.max_seqlen_for_chunk(chunk_len, 5),
                                   alphabet, fp, seqlen_granularity=128)
    batch = jtrain.Batch(batch.signal, batch.seqs, batch.seqlens.copy(),
                         None)
    batch.seqlens[-1] = 0               # one padding row, as _pad_batch
    return batch


def _to_jax(batch):
    return jtrain.Batch(*(None if a is None else jnp.asarray(a)
                          for a in batch))


def _nets(seed, models=(jmodel, tmodel)):
    jnet = models[0].network(size=16, stride=5, winlen=19)
    params = jnet.init(np.random.default_rng(seed))
    tnet = load_jax_params(models[1].network(size=16, stride=5, winlen=19),
                           params)
    return jnet, params, tnet


def _check_params_after_step(tnet, new_params, grad_diff, lr):
    want = jax.tree.leaves(new_params)
    named = dict(tnet.named_parameters())
    for name, w, d in zip(leaf_names(tnet), want, grad_diff):
        got = named[name].detach().numpy()
        w = np.asarray(w)
        tol = lr * d / 1e-6 + 1e-6 * np.abs(w) + 1e-7
        assert (np.abs(got - w) <= tol).all(), name


# the model files of each package, and the port's residual switch (the
# JAX package's CPU path takes no switch: it is the reference for all)
STEP_CASES = {
    "mLstm": ((jmodel, tmodel), {}),
    "mLstm-ACTS_BWD=0": ((jmodel, tmodel), {"TAIYAKI_TPU_ACTS_BWD": "0"}),
    "mLstm-RECOMPUTE=1": ((jmodel, tmodel), {"TAIYAKI_TPU_RECOMPUTE": "1"}),
    "mGru-NO_RECOMPUTE=1": ((jgru_model, tgru_model),
                            {"TAIYAKI_TPU_NO_RECOMPUTE": "1"}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, monkeypatch):
    """Loss, every gradient in the JAX leaf order, grad_maxs and the
    parameters after one clipped AdamW step; the port under each residual
    policy's switch."""
    models, env = STEP_CASES[case]
    batch = _batch(seed=2)
    jnet, params, tnet = _nets(seed=7, models=models)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    lr0 = 1e-4
    opt, _ = jtrain.make_optimizer(4e-3, 10, 2, lr0, 1e-4)
    threshs = np.full(len(jax.tree.leaves(params)), np.inf, np.float32)
    threshs[0] = 1e-3                     # clip one tensor
    jloss, jgrads = jax.value_and_grad(jtrain.make_loss_fn(jnet))(
        params, _to_jax(batch), 1.0)
    new_params, _, jloss2, jmaxs = jax.jit(jtrain.make_train_step(jnet, opt))(
        params, opt.init(params), _to_jax(batch), 1.0, 1.0,
        jnp.asarray(threshs))

    named = dict(tnet.named_parameters())
    topt, _ = ttrain.make_optimizer([named[n] for n in leaf_names(tnet)],
                                    4e-3, 10, 2, lr0, 1e-4)
    tbatch = ttrain.batch_to_device(batch, torch.device("cpu"))
    tloss, tgrads = ttrain.make_grad_step(tnet)(tbatch, 1.0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    diffs = []
    for g, w in zip(tgrads, jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        d = np.abs(g.numpy() - w).max()
        assert d <= 1e-4 * max(np.abs(w).max(), 1e-30), d
        diffs.append(d)
    tmaxs = ttrain.make_apply_step(topt)(tgrads, 1.0, threshs)
    np.testing.assert_allclose(tmaxs.numpy(), np.asarray(jmaxs), rtol=1e-4)
    assert float(jloss2) == pytest.approx(float(jloss), rel=1e-6)
    _check_params_after_step(tnet, new_params, diffs, lr0)


def test_sub_batch_accumulation_matches_jax():
    """Two sub-batches accumulated, averaged, clipped and applied once."""
    batches = [_batch(seed=4, n=4), _batch(seed=5, n=4)]
    jnet, params, tnet = _nets(seed=8)
    lr0 = 2e-4
    opt, _ = jtrain.make_optimizer(4e-3, 10, 2, lr0, 1e-4)
    nleaf = len(jax.tree.leaves(params))
    threshs = np.full(nleaf, np.inf, np.float32)
    gstep = jax.jit(jtrain.make_grad_step(jnet))
    acc = None
    for b in batches:
        _, g = gstep(params, _to_jax(b), 1.0, 1.0)
        acc = jtrain.accumulate_grads(acc, g)
    new_params, _, jmaxs = jtrain.make_apply_step(opt)(
        params, opt.init(params), acc, 2.0, jnp.asarray(threshs))

    named = dict(tnet.named_parameters())
    topt, _ = ttrain.make_optimizer([named[n] for n in leaf_names(tnet)],
                                    4e-3, 10, 2, lr0, 1e-4)
    tgstep = ttrain.make_grad_step(tnet)
    tacc = None
    for b in batches:
        _, g = tgstep(ttrain.batch_to_device(b, torch.device("cpu")), 1.0)
        tacc = ttrain.accumulate_grads(tacc, g)
    diffs = [float(np.abs(g.numpy() - np.asarray(w)).max())
             for g, w in zip(tacc, jax.tree.leaves(acc))]
    tmaxs = ttrain.make_apply_step(topt)(tacc, 2.0, threshs)
    np.testing.assert_allclose(tmaxs.numpy(), np.asarray(jmaxs), rtol=1e-4)
    _check_params_after_step(tnet, new_params, [d / 2 for d in diffs], lr0)


def _fixed_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        1e-2 * rng.normal(size=p.shape).astype(np.float32)), params)


def _port_step(topt, grads):
    topt.step([torch.from_numpy(np.array(g)) for g in jax.tree.leaves(grads)])


OPT_LAYOUTS = {"adamw": None, "momentum_cycling": 0.85}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("layout", sorted(OPT_LAYOUTS))
def test_optimizer_state_resumes_across_packages(layout, direction,
                                                 tmp_path):
    """Two AdamW steps on fixed gradients in one package, saved by its
    save_model with its optimizer state (either optax layout: plain AdamW,
    or inject_hyperparams under --min_momentum); the checkpoint loads in
    the other package, which takes the third step: its parameters equal
    the first package's third step within 1e-6, and the state it loads
    carries both step counts."""
    import optax
    from taiyaki_tpu.utils import helpers as jhelpers
    from taiyaki_tpu_torch.convert import params_to_jax
    from taiyaki_tpu_torch.utils import helpers as thelpers
    mm = OPT_LAYOUTS[layout]
    kwargs = dict(size=16, stride=5, winlen=19, insize=1,
                  alphabet_info=None)
    jnet, source, meta = jhelpers.new_model(
        os.path.join(REPO, "taiyaki_tpu", "models", "mLstm_flipflop.py"),
        **kwargs)
    params = jnet.init(np.random.default_rng(3))
    grads = [_fixed_grads(params, seed) for seed in range(3)]
    opt, _ = jtrain.make_optimizer(4e-3, 10, 2, 1e-4, 1e-4,
                                   min_momentum=mm)

    def port_opt(tnet):
        return ttrain.make_optimizer(ttrain.leaf_params(tnet), 4e-3, 10, 2,
                                     1e-4, 1e-4, min_momentum=mm)[0]

    jp, state = params, opt.init(params)
    jsteps = []
    for g in grads:
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        jsteps.append((jax.tree.map(np.asarray, jp),
                       jax.tree.map(np.asarray, state)))
    if direction == "jax_to_port":
        jhelpers.save_model(str(tmp_path), jnet, jsteps[1][0], source,
                            kwargs, meta, optimizer_state=jsteps[1][1])
        tnet, tparams, *_, tstate = thelpers.load_model(
            str(tmp_path / "model_final.checkpoint"))
        tnet = load_jax_params(tnet, tparams)
        topt = port_opt(tnet)
        topt.load_jax_state(tnet, tstate)
        assert (topt.count, topt.adam_count) == (2, 2)
        _port_step(topt, grads[2])
        got, want = params_to_jax(tnet), jsteps[2][0]
    else:
        tnet = load_jax_params(tmodel.network(size=16, stride=5, winlen=19),
                               params)
        topt = port_opt(tnet)
        for g in grads[:2]:
            _port_step(topt, g)
        thelpers.save_model(str(tmp_path), tnet, params_to_jax(tnet), source,
                            kwargs, meta,
                            optimizer_state=topt.jax_state(tnet))
        _, p2, *_, jstate = jhelpers.load_model(
            str(tmp_path / "model_final.checkpoint"))
        assert jax.tree.structure(jstate) == jax.tree.structure(
            jsteps[1][1])
        for a, b in zip(jax.tree.leaves(jstate),
                        jax.tree.leaves(jsteps[1][1])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        upd, _ = opt.update(grads[2], jstate, p2)
        got = optax.apply_updates(p2, upd)
        _port_step(topt, grads[2])
        want = params_to_jax(tnet)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_optimizer_state_of_another_layout_raises():
    """A checkpoint's optax state that is not the optimizer's layout (the
    plain AdamW state under --min_momentum) raises with its classes."""
    from taiyaki_tpu_torch.utils import helpers as thelpers
    jnet, params, tnet = _nets(seed=1)
    opt, _ = jtrain.make_optimizer(4e-3, 10, 2, 1e-4, 1e-4)
    state = pickle.dumps(jax.tree.map(np.asarray, opt.init(params)))
    state = thelpers._CheckpointUnpickler(io.BytesIO(state)).load()
    topt, _ = ttrain.make_optimizer(ttrain.leaf_params(tnet), 4e-3, 10, 2,
                                    1e-4, 1e-4, min_momentum=0.85)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        topt.load_jax_state(tnet, state)


CLI_ARGS = ["--device", "cpu", "--size", "16", "--stride", "2", "--winlen",
            "9", "--niteration", "3", "--warmup_batches", "1",
            "--chunk_len_min", "300", "--chunk_len_max", "400",
            "--min_sub_batch_size", "4", "--save_every", "2",
            "--sample_nreads_before_filtering", "50",
            "--reporting_sub_batches", "10", "--seed", "5", "--quiet"]


def _train_both(d, model, extra=()):
    """bin/train_flipflop.py and the port's CLI, same arguments (CLI_ARGS,
    then `extra`) and seed, the model file `model` of each package (or one
    checkpoint, given by its path) on the repo's mapped reads."""
    out = {}
    for tag, cmd, pkg in (
            ("jax", [os.path.join(REPO, "bin", "train_flipflop.py")],
             "taiyaki_tpu"),
            ("port", ["-m", "taiyaki_tpu_torch.cli.train_flipflop"],
             "taiyaki_tpu_torch")):
        outdir = str(d / tag)
        r = subprocess.run([sys.executable] + cmd + CLI_ARGS + list(extra)
                           + ["--outdir", outdir,
                              os.path.join(REPO, pkg, "models", model),
                              READS], cwd=REPO,
                           env=_env(), capture_output=True, text=True,
                           timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        out[tag] = outdir
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both CLIs on mLstm_flipflop (one run, shared by the workers)."""
    return shared_run(tmp_path_factory, "train",
                      lambda d: _train_both(d, "mLstm_flipflop.py"))


@pytest.fixture(scope="module")
def trained_gru(tmp_path_factory):
    """Both CLIs on mGru_flipflop (one run, shared by the workers)."""
    return shared_run(tmp_path_factory, "train_gru",
                      lambda d: _train_both(d, "mGru_flipflop.py"))


def _log(outdir, name):
    with open(os.path.join(outdir, name)) as fh:
        return [line.split("\t") for line in fh.read().splitlines()]


def _logs_match(trained, niter=3):
    jrows, trows = (_log(trained[k], "batch.log") for k in ("jax", "port"))
    assert trows[0] == jrows[0]
    assert len(trows) == len(jrows) == niter + 1
    for i, (t, j) in enumerate(zip(trows[1:], jrows[1:])):
        assert (t[0], t[3], t[5]) == (j[0], j[3], j[5])
        rtol = 1e-5 if i == 0 else 1e-4
        np.testing.assert_allclose(float(t[1]), float(j[1]), rtol=rtol)
        np.testing.assert_allclose(
            [float(v) for v in t[2].split(",")],
            [float(v) for v in j[2].split(",")], rtol=10 * rtol)
        np.testing.assert_allclose(float(t[4]), float(j[4]), rtol=1e-5)
    jval, tval = (_log(trained[k], "validation.log") for k in ("jax",
                                                              "port"))
    assert [r[0] for r in tval] == [r[0] for r in jval] == ["iter", "2"]
    np.testing.assert_allclose(float(tval[1][1]), float(jval[1][1]),
                               rtol=1e-4)


def test_cli_batch_log_matches_jax(trained):
    _logs_match(trained)


def test_cli_batch_log_matches_jax_mgru(trained_gru):
    """The same for mGru_flipflop (size 16, stride 2): the GRU layers'
    forward and recomputing backward through three AdamW steps."""
    _logs_match(trained_gru)


def test_cli_resume_matches_jax(trained, tmp_path):
    """Both CLIs resume the JAX run's first checkpoint, its parameters and
    its optimizer state (Adam's moments, the schedule's step count), for
    2 iterations: batch.log rows equal at the pair tolerances (a port
    that restarted Adam would differ from the second iteration on)."""
    ckpt = os.path.join(trained["jax"], "model_checkpoint_00001.checkpoint")
    _logs_match(_train_both(tmp_path, ckpt, ["--niteration", "2",
                                             "--reporting_sub_batches", "1"]),
                niter=2)


def test_cli_checkpoint_loads_in_jax(trained):
    """The port's final checkpoint loads in the JAX package with the
    port's parameters, equal to the JAX run's within the Adam bound, and
    with an optimizer state of the JAX run's structure and step count."""
    from taiyaki_tpu.utils import helpers as jhelpers
    net, params, _, meta, kwargs, opt_state = jhelpers.load_model(
        os.path.join(trained["port"], "model_final.checkpoint"))
    _, jparams, *_, jopt_state = jhelpers.load_model(
        os.path.join(trained["jax"], "model_final.checkpoint"))
    with open(os.path.join(trained["port"], "model_final.params"),
              "rb") as fh:
        raw = pickle.load(fh)
    assert jax.tree.structure(opt_state) == jax.tree.structure(jopt_state)
    assert int(opt_state[0].count) == int(jopt_state[0].count) == 3
    assert meta["version"] == 3
    assert kwargs["alphabet_info"].alphabet == "ACGT"
    got, want = jax.tree.leaves(params), jax.tree.leaves(jparams)
    assert jax.tree.structure(params) == jax.tree.structure(jparams)
    for g, w, r in zip(got, want, jax.tree.leaves(raw)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)
    x = np.random.default_rng(0).normal(size=(60, 2, 1)).astype(np.float32)
    assert np.isfinite(np.asarray(net.apply(params, jnp.asarray(x)))).all()
    for name in ("model.log", "model_checkpoint_00001.checkpoint",
                 "model_checkpoint_00001.params"):
        assert os.path.exists(os.path.join(trained["port"], name))


def test_cli_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, "-m", "taiyaki_tpu_torch.cli.train_flipflop",
         "--outdir", str(tmp_path / "o"), "--niteration", "2",
         os.path.join(REPO, "taiyaki_tpu_torch", "models",
                      "mLstm_flipflop.py"), READS], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_remat_gives_the_same_step(case, monkeypatch):
    """The loss and every gradient with each layer's forward run again in
    the backward pass (`layers.set_remat`, the CLI's --remat) equal those
    without, under each residual policy's switch: the recurrences'
    autograd Functions keep their policy on the context and rebuild every
    saved tensor in the rerun."""
    from taiyaki_tpu_torch import layers
    models, env = STEP_CASES[case]
    batch = ttrain.batch_to_device(_batch(seed=3), torch.device("cpu"))
    _, _, tnet = _nets(seed=9, models=models)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    gstep = ttrain.make_grad_step(tnet)
    loss, grads = gstep(batch, 1.0)
    layers.set_remat(tnet)
    assert all(m.remat for m in tnet.modules()
               if isinstance(m, layers.Serial))
    rloss, rgrads = gstep(batch, 1.0)
    assert float(rloss) == float(loss)
    for g, r in zip(grads, rgrads):
        np.testing.assert_allclose(r.numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-9)


@pytest.fixture(scope="module")
def trained_remat(tmp_path_factory):
    """Both CLIs on mLstm_flipflop with --remat (one run, shared by the
    workers)."""
    return shared_run(tmp_path_factory, "train_remat",
                      lambda d: _train_both(d, "mLstm_flipflop.py",
                                            ["--remat"]))


def _params(outdir, name):
    with open(os.path.join(outdir, name + ".params"), "rb") as fh:
        return jax.tree.leaves(pickle.load(fh))


@pytest.mark.parametrize("name", ["model_checkpoint_00001", "model_final"])
def test_cli_remat_matches_no_remat_and_jax(trained_remat, trained, name):
    """The port's CLI with --remat against itself without it and against
    bin/train_flipflop.py --remat, same seed and arguments: the parameters
    after 2 iterations (the first checkpoint) and after 3 within 1e-5, and
    the batch.log rows at the pair tolerances."""
    got = _params(trained_remat["port"], name)
    for want in (_params(trained["port"], name),
                 _params(trained_remat["jax"], name)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    _logs_match(trained_remat)


@pytest.mark.parametrize("flag", [["--multihost"],
                                  ["--mod_prior_factor", "1.0"]])
def test_cli_unported_options_stop(flag, tmp_path):
    """Options not ported stop; --mod_prior_factor, ported, stops on the
    repo's modref reads, which lack a label whose prior it needs, as
    bin/train_flipflop.py does."""
    from taiyaki_tpu_torch.cli import train_flipflop
    model, reads, err, why = "mLstm_flipflop.py", READS, SystemExit, \
        "not ported"
    if flag[0] == "--mod_prior_factor":
        model, err, why = "mLstm_cat_mod_flipflop.py", NotImplementedError, \
            "must occur"
        reads = os.path.join(os.path.dirname(READS),
                             "mapped_remap_modref.hdf5")
    with pytest.raises(err, match=why):
        train_flipflop.main(flag + [
            "--device", "cpu", "--size", "16", "--outdir",
            str(tmp_path / "o"),
            os.path.join(REPO, "taiyaki_tpu_torch", "models", model),
            reads])
