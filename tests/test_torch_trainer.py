"""The port's training substrate against the reference: the synthetic
data stream (tokens, labels and masks bit-equal to the reference's for
the same seed and step; modality stubs the same in every process, where
the reference's are not), checkpoints (one state written by either
package gives the same manifest and files, and restores in the other),
atomic keep-N, the async checkpointer's host copy, the port's copies of
``tests/test_system.py``'s trainer tests (loss decreases, resume, NaN
rollback) at the tiny shape, and ``python -m repro_torch.launch.train``
on the CPU."""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch.mesh import make_mesh_for
from repro.models import get_model_def as j_model_def
from repro.models.module import init_params as j_init
from repro.train import checkpoint as j_ckpt
from repro.train.data import SyntheticLMData as JData
from repro.train.optimizer import adamw as j_adamw
from repro.train.optimizer import constant_schedule as j_constant

from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.models import from_jax_state, get_model_def
from repro_torch.models.convert import stack_blocks
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.data import SyntheticLMData as TData
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(seq_len=64, global_batch=4, kind="train")
J_SHAPES.setdefault("tiny", TINY)
T_SHAPES.setdefault("tiny", TINY)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "llava-next-mistral-7b"])
def test_data_stream_equals_the_reference(arch):
    jd = JData(j_smoke(arch), "tiny", make_mesh_for(1, 1), seed=3)
    td = TData(t_smoke(arch), "tiny", seed=3, device="cpu")
    for step in (0, 17):
        want, got = jd.batch(step), td.batch(step)
        assert set(got) == set(want)
        for key in ("tokens", "labels", "loss_mask"):
            w = np.asarray(want[key])
            assert got[key].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[key].numpy(), w)
        if "image_embeds" in want:  # seeded differently on purpose
            assert tuple(got["image_embeds"].shape) == \
                want["image_embeds"].shape
            assert got["image_embeds"].dtype == torch.bfloat16
    b = td.batch(17)
    np.testing.assert_array_equal(b["labels"][:, :-1].numpy(),
                                  b["tokens"][:, 1:].numpy())
    assert not torch.equal(b["tokens"], td.batch(18)["tokens"])
    td.start(5)  # the prefetch thread yields the same pure batches
    try:
        for step in (5, 6):
            nxt = td.next()
            for key, t in td.batch(step).items():
                assert torch.equal(nxt[key], t)
    finally:
        td.stop()


_STUBS = """
import hashlib, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro.configs import smoke_config as js
from repro.configs.base import SHAPES as JS
from repro.launch.mesh import make_mesh_for
from repro.train.data import SyntheticLMData as JD
from repro_torch.configs import SHAPES as TS, smoke_config as ts
from repro_torch.train.data import SyntheticLMData as TD
for shapes in (JS, TS):
    shapes["tiny"] = dict(seq_len=64, global_batch=2, kind="train")
arch = "llava-next-mistral-7b"
j = np.asarray(JD(js(arch), "tiny", make_mesh_for(1, 1), seed=0)
               .batch(3)["image_embeds"]).astype(np.float32)
t = TD(ts(arch), "tiny", seed=0, device="cpu").batch(3)["image_embeds"]
print(hashlib.sha256(j.tobytes()).hexdigest(),
      hashlib.sha256(t.float().numpy().tobytes()).hexdigest())
"""


def test_modality_stubs_are_the_same_in_every_process():
    """The reference seeds its patch embeddings with ``hash(name)``, which
    ``PYTHONHASHSEED`` changes from process to process; the port's seed
    (crc32 of the name) does not."""
    outs = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed,
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", _STUBS.format(src=str(ROOT / "src"))],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.split())
    (ref1, port1), (ref2, port2) = outs
    assert ref1 != ref2  # the reference's stubs change with the hash seed
    assert port1 == port2  # the port's do not


def _reference_state(jc):
    md = j_model_def(jc)
    params = j_init(md.specs(jc), jax.random.PRNGKey(0))
    opt = j_adamw(j_constant(1e-3))
    state = {"params": params, "opt": opt.init(params)}
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                         params)  # one update: m, v and step nonzero
    params, ostate, _ = opt.update(grads, state["opt"], params)
    return {"params": params, "opt": ostate}


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)


@pytest.mark.parametrize("arch", ["camformer-bert", "granite-moe-3b-a800m"])
def test_checkpoints_cross_restore(tmp_path, arch):
    jc, tc = j_smoke(arch), t_smoke(arch)
    jstate = _reference_state(jc)
    state_np = jax.tree.map(np.asarray, jstate)
    tstate = from_jax_state(state_np, tc, "cpu")
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 7)
    t_ckpt.save_checkpoint(str(tmp_path / "port"), tstate, 7)
    # one state, one layout: the same manifest and the same .npy bytes
    _same_files(tmp_path / "jax" / "step_7", tmp_path / "port" / "step_7")

    # written by JAX, restored by the port (into a fresh port state)
    _, opt = make_train_step(get_model_def(tc), tc)
    fresh = init_state(tc, opt, seed=1, device="cpu")
    got, step = t_ckpt.restore_checkpoint(str(tmp_path / "jax"), fresh)
    assert step == 7 and got is fresh
    for a, b in zip(jax.tree.leaves(stack_blocks(got)),
                    jax.tree.leaves(state_np)):
        np.testing.assert_array_equal(a, b)

    # a port state after one train step, restored by JAX
    step_fn, _ = make_train_step(get_model_def(tc), tc, warmup=1)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, tc.vocab, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    tstate, _ = step_fn(tstate, batch)
    t_ckpt.save_checkpoint(str(tmp_path / "port2"), tstate, 8)
    restored, step = j_ckpt.restore_checkpoint(str(tmp_path / "port2"),
                                               jstate)
    assert step == 8
    for a, b in zip(jax.tree.leaves(restored),
                    jax.tree.leaves(stack_blocks(tstate))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_atomic_and_keep_n(tmp_path):
    d = str(tmp_path / "ck")
    state = {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3))}}
    for s in (1, 2, 3, 4):
        t_ckpt.save_checkpoint(d, state, s, keep=2)
    assert t_ckpt.latest_step(d) == 4
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                   if n.startswith("step_"))
    assert steps == [3, 4]  # keep-N pruned
    into = {"a": torch.zeros(8), "b": {"c": torch.zeros((3, 3))}}
    got, step = t_ckpt.restore_checkpoint(d, into)
    assert step == 4
    assert torch.equal(got["a"], state["a"])
    assert torch.equal(got["b"]["c"], state["b"]["c"])
    assert not any(n.startswith("tmp_") for n in os.listdir(d))
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore_checkpoint(d, {"a": torch.zeros(4),
                                      "b": {"c": torch.zeros((3, 3))}})
    with pytest.raises(KeyError, match="lacks"):
        t_ckpt.restore_checkpoint(d, dict(into, x=torch.zeros(1)))


def test_async_checkpoint_is_not_torn_by_in_place_updates(tmp_path):
    """``save`` copies the state to the host before it returns, so an
    in-place update right after it (the optimizer's) is not written."""
    d = str(tmp_path / "ck")
    ck = t_ckpt.AsyncCheckpointer(d, keep=2)
    state = {"params": {"blocks": [{"w": torch.full((256, 256), float(i))}
                                   for i in range(3)],
                        "ln_f": {"scale": torch.ones(256)}},
             "opt": {"step": torch.tensor(1, dtype=torch.int32)}}
    want = stack_blocks({"params": state["params"],
                         "opt": state["opt"]})
    want = jax.tree.map(np.copy, want)
    for step in (1, 2):
        ck.save(state, step)
        for t in (state["params"]["ln_f"]["scale"],
                  *(b["w"] for b in state["params"]["blocks"])):
            t.add_(100.0)  # while the worker writes
        state["opt"]["step"].add_(1)
        ck.wait()
        into = jax.tree.map(torch.zeros_like, state)
        got, _ = t_ckpt.restore_checkpoint(d, into, step=step)
        for a, b in zip(jax.tree.leaves(stack_blocks(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
        want = jax.tree.map(lambda a: a + (100 if a.dtype.kind == "f"
                                           else 1), want)


def _mk_trainer(tmp_path, steps=8, arch="codeqwen1.5-7b"):
    cfg = t_smoke(arch)
    data = TData(cfg, "tiny", device="cpu")
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=4, log_every=2,
                         ckpt_dir=str(tmp_path / "ckpt"), warmup=2)
    return Trainer(get_model_def(cfg), cfg, data, tcfg, device="cpu")


def test_trainer_loss_decreases_and_checkpoints(tmp_path):
    """The reference's test compares the first and last logged training
    losses, each on its own batch, which 12 steps at lr 3e-4 move by less
    than the batch-to-batch spread; this copy holds the loss on four
    fixed held-out batches before and after training."""
    trainer = _mk_trainer(tmp_path, steps=12)
    md, cfg = trainer.md, trainer.cfg
    held = [trainer.data.batch(5000 + i) for i in range(4)]

    def held_out(params):
        with torch.no_grad():
            return np.mean([float(md.loss(params, b, cfg)[0]) for b in held])

    before = held_out(trainer.init_state()["params"])
    state = trainer.run()
    log = trainer.metrics_log
    assert [r["step"] for r in log] == list(range(2, 13, 2))
    assert all(np.isfinite(r["loss"]) for r in log)
    assert held_out(state["params"]) < before - 0.05
    assert t_ckpt.latest_step(trainer.tcfg.ckpt_dir) == 12


def test_trainer_resume_continues_from_checkpoint(tmp_path):
    _mk_trainer(tmp_path, steps=8).run()
    trainer2 = _mk_trainer(tmp_path, steps=12)
    trainer2.run()
    assert (8, "resume", "restored step_8") in trainer2.events
    assert [r["step"] for r in trainer2.metrics_log] == [10, 12]
    assert t_ckpt.latest_step(trainer2.tcfg.ckpt_dir) == 12


def test_trainer_nan_rollback(tmp_path):
    _mk_trainer(tmp_path, steps=8).run()

    class PoisonData:
        """Wraps the stream; poisons exactly one step after resume."""

        def __init__(self, inner):
            self.inner, self.count = inner, 0

        def batch(self, step):
            b = self.inner.batch(step)
            if self.count == 1:
                b = dict(b, loss_mask=b["loss_mask"] * float("nan"))
            self.count += 1
            return b

    trainer2 = _mk_trainer(tmp_path, steps=12)
    trainer2.data = PoisonData(trainer2.data)
    trainer2.run()
    # the second batch after the resume at 8 (step 9) is poisoned
    assert [ev[:2] for ev in trainer2.events] == [(8, "resume"),
                                                  (9, "rollback")]
    assert t_ckpt.latest_step(trainer2.tcfg.ckpt_dir) == 12  # completed


def _train_cli(tmp_path, arch, steps):
    """Run ``launch.train`` on the CPU for ``steps`` steps with a
    checkpoint every 2; check its last step line and checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--steps", str(steps), "--device", "cpu",
         "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"{{'step': {steps}, 'loss':" in proc.stdout
    assert t_ckpt.latest_step(str(tmp_path / "ck")) == steps


def test_train_cli_on_the_cpu(tmp_path, monkeypatch):
    _train_cli(tmp_path, "camformer-bert", 4)
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "camformer-bert", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ck2")])


@pytest.mark.parametrize("arch", ["whisper-medium", "recurrentgemma-2b"])
def test_train_cli_runs_whisper_and_recurrentgemma(tmp_path, arch):
    """The encoder-decoder (whisper-medium) and Griffin hybrid
    (recurrentgemma-2b) families train through the CLI on the CPU: two
    steps, a checkpoint at step 2."""
    _train_cli(tmp_path, arch, 2)
