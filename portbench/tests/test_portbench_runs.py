"""Whole runs of tiny cells on the CPU, from a copy of the benchmark: the
result's line, a cell added by files alone, and the check failing on a
broken program, on the control and on each fault a cell can have."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

SEED = 2 ** 31 + 12345

# faults planted under the harness, in the program's own step
FAULTS = {
    "none": "",
    "state_unchanged": """
        import deepspeech_tpu_torch.train.step as S
        real = S.make_train_step
        def make(model, optimizer, cfg, mesh=None):
            step = real(model, optimizer, cfg, mesh)
            def broken(state, batch, **kw):
                params = [p.detach().clone() for p in model.parameters()]
                trace = [t.clone() for t in state.opt_state["trace"]]
                m = step(state, batch, **kw)
                with torch.no_grad():
                    for p, q in zip(model.parameters(), params):
                        p.copy_(q)
                    for t, u in zip(state.opt_state["trace"], trace):
                        t.copy_(u)
                return m
            return broken
        S.make_train_step = make
    """,
    "half_batch": """
        import deepspeech_tpu_torch.train.step as S
        real = S.make_train_step
        def make(model, optimizer, cfg, mesh=None):
            step = real(model, optimizer, cfg, mesh)
            def broken(state, batch, **kw):
                valid = batch["valid"].clone()
                valid[valid.shape[0] // 2:] = 0
                return step(state, {**batch, "valid": valid}, **kw)
            return broken
        S.make_train_step = make
    """,
    "token_altered": """
        import deepspeech_tpu_torch.train.step as S
        real = S.make_eval_step
        def make(model, cfg):
            step = real(model, cfg)
            def broken(batch):
                m = step(batch)
                c = m["probs"].shape[-1]
                m["greedy"][:, 0] = (m["greedy"][:, 0] + 1) % c
                return m
            return broken
        S.make_eval_step = make
    """,
    # every BatchNorm's running statistics left at their initial 0 and 1
    "bn_stats_reset": """
        import deepspeech_tpu_torch.train.step as S
        real = S.make_eval_step
        def make(model, cfg):
            with torch.no_grad():
                for name, b in model.named_buffers():
                    if name.endswith("running_mean"):
                        b.zero_()
                    elif name.endswith("running_var"):
                        b.fill_(1.0)
            return real(model, cfg)
        S.make_eval_step = make
    """,
}


def run_copy(root: str, workload: str, fault: str = "none",
             seconds: float = 0.0) -> tuple:
    """One run of ``workload`` from the copy at ``root`` on the CPU ->
    (exit code, the last line of stdout parsed, stderr)."""
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{root!r}, {tiny.REPO!r}]
        import torch
        torch.set_num_threads(2)
    """) + textwrap.dedent(FAULTS[fault]) + textwrap.dedent(f"""
        from portbench import run
        raise SystemExit(run.main(["--workload", {workload!r}, "--seed",
                                   "{SEED}", "--seconds", "{seconds}",
                                   "--trace", "0"],
                                  device=torch.device("cpu")))
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=root)
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "null"
    return p.returncode, json.loads(last), p.stderr


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-eval"])
def test_sound_run_is_correct_and_its_line_has_the_result_keys(
        copy, workload):
    rc, line, err = run_copy(copy, workload)
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True, line["check"]
    rate = ("infer" if "eval" in workload else "train") + "_audio_s_per_s"
    assert set(line["metrics"]) == {rate, "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["check"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


@pytest.mark.parametrize("workload,fault", [
    ("tiny-train", "state_unchanged"),
    ("tiny-train", "half_batch"),
    ("tiny-eval", "token_altered"),
    ("tiny-eval", "bn_stats_reset"),
])
def test_broken_program_is_not_correct(copy, workload, fault):
    rc, line, err = run_copy(copy, workload, fault)
    assert rc == 0, err
    assert line["correct"] is False, line["check"]


def test_forbidden_module_in_the_process_gives_no_result(copy):
    """A run whose process holds a module named ``jax`` exits non-zero and
    prints no result (a stand-in module: the check reads names only)."""
    script = textwrap.dedent(f"""
        import sys, types
        sys.path[:0] = [{copy!r}, {tiny.REPO!r}]
        sys.modules["jax"] = types.ModuleType("jax")
        import torch
        from portbench import run
        raise SystemExit(run.main(["--workload", "tiny-eval", "--seed", "1",
                                   "--seconds", "0", "--trace", "0"],
                                  device=torch.device("cpu")))
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=copy)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "jax" in p.stderr


def test_without_a_card_the_run_exits_without_a_result(copy):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tiny-eval", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=copy,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_benchmark_folder_alone_exits_without_a_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the program is not
    there, so the run fails before any result."""
    import shutil

    shutil.copytree(os.path.join(tiny.REPO, "portbench"),
                    tmp_path / "portbench")
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(tmp_path)!r}]
        import torch
        from portbench import run
        raise SystemExit(run.main(["--workload", "train-gru800-b20-ls100",
                                   "--seed", "1", "--seconds", "1",
                                   "--trace", "0"],
                                  device=torch.device("cpu")))
    """)
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
