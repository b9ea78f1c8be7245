"""The port's LM training launcher (``repro_torch.launch.train``) on the
CPU: the reference's loss-decrease bound on reduced TinyLlama in 30 steps
(``tests/test_system.py::test_train_driver_loss_decreases``); a run cut
after 4 steps and resumed from its checkpoint gives the straight run's
losses bit for bit (the warm-up is 20 steps, so the cut run's shorter
schedule is the same there); train states cross between the packages
through their checkpoints, each stepped on to the other's next step
(``test_torch_train_step.py``'s tolerances); the reference's flags and
defaults, with ``--device`` defaulting to the card and raising without
one, and ``--ckpt-dir`` defaulting to a fresh directory for each run
(the reference's one fixed directory let a run resume another's)."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jlaunch  # noqa: E402
from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_train import batch_np, cfgs, to_torch  # noqa: E402
from test_torch_train_step import check_states, opt_cfgs  # noqa: E402

ARCH = "tinyllama_1_1b"


def test_launcher_loss_decreases_on_the_cpu(tmp_path, capsys):
    losses = tlaunch.run(ARCH, True, steps=30, batch=4, seq=32,
                         ckpt_dir=str(tmp_path), ckpt_every=0, lr=3e-3,
                         log_every=100, device="cpu")
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert "[train] step    29 loss" in capsys.readouterr().out


def test_cut_and_resumed_run_equals_the_straight_run(tmp_path, capsys):
    kw = dict(batch=2, seq=16, lr=3e-3, log_every=100, device="cpu")
    straight = tlaunch.run(ARCH, True, steps=8, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=0, **kw)
    cut = tlaunch.run(ARCH, True, steps=4, ckpt_dir=str(tmp_path / "b"),
                      ckpt_every=4, **kw)
    assert tckpt.latest_step(str(tmp_path / "b")) == 4
    resumed = tlaunch.run(ARCH, True, steps=8, ckpt_dir=str(tmp_path / "b"),
                          ckpt_every=4, **kw)
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert cut + resumed == straight


def _steppers():
    jcfg, tcfg = cfgs(ARCH)
    jo, to = opt_cfgs()
    jstep = jax.jit(jts.make_train_step(
        jcfg, JCtx(mesh=None, remat="none", q_chunk=64),
        jts.StepConfig(opt=jo)))
    tstep = tts.make_train_step(tcfg, TCtx(q_chunk=64),
                                tts.StepConfig(opt=to))
    b = batch_np(jcfg, seed=5, b=2, s=16)
    return jcfg, tcfg, lambda s: jstep(s, jax.tree.map(jnp.asarray, b)), \
        lambda s: tstep(s, to_torch(b))


def test_reference_state_restored_and_stepped_by_the_port(tmp_path):
    jcfg, tcfg, jstep, tstep = _steppers()
    js = jts.init_train_state(jcfg, jax.random.PRNGKey(3))
    jckpt.save(str(tmp_path), 7, js)
    like = tts.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    ts, step = tckpt.restore(str(tmp_path), like)
    assert step == 7
    ts, _ = tstep(ts)
    js1, _ = jstep(js)
    check_states(ts, js1, 1, js)


def test_port_state_restored_and_stepped_by_the_reference(tmp_path):
    jcfg, tcfg, jstep, tstep = _steppers()
    ts = tts.init_train_state(tcfg, torch.Generator().manual_seed(3), "cpu")
    tckpt.save(str(tmp_path), 7, ts)
    like = jts.init_train_state(jcfg, jax.random.PRNGKey(0))
    js, step = jckpt.restore(str(tmp_path), like)
    assert step == 7
    js1, _ = jstep(js)
    ts, _ = tstep(ts)
    check_states(ts, js1, 1, js)


def test_the_reference_flags_and_defaults():
    want = vars(jlaunch.build_parser().parse_args([]))
    got = vars(tlaunch.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    # no fixed shared directory: a fresh one for each run (below)
    assert got.pop("ckpt_dir") is None
    want.pop("ckpt_dir")
    assert got == want
    for argv in (["--full"], ["--no-reduced"]):
        assert tlaunch.build_parser().parse_args(argv).reduced is False
    assert tlaunch.build_parser().parse_args(
        ["--embed-method", "onehot"]).embed_method == "onehot"


def test_default_checkpoint_dir_is_fresh_for_each_run(monkeypatch,
                                                      tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]
    outs = []
    for _ in range(2):
        tlaunch.main(argv)
        outs.append(capsys.readouterr().out)
        assert "resumed" not in outs[-1]
        assert "[train] step     1 loss" in outs[-1]
    dirs = sorted(tmp_path.iterdir())
    assert len(dirs) == 2
    assert [tckpt.latest_step(str(d)) for d in dirs] == [2, 2]
    for d in dirs:
        assert sum(f"[train] checkpoints in {d}\n" in o for o in outs) == 1


def test_launcher_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tlaunch.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
