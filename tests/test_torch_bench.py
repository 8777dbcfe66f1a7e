"""The port bench (``raycastworlds_tpu_torch.bench``) against the JAX
package's ``bench.py``, on the CPU at small widths.

* ``SUITE`` and the PPO rows are the JAX bench's, name for name and
  argument for argument.
* ``build_env`` builds every ``SUITE`` row (at 4 envs) and the textured,
  ``flood_iters``, ``pallas`` and ``analytic`` variants as the JAX
  ``build_env`` does: the same family, env count, reset budget and every
  config field.
* ``_roofline`` counts the JAX work model's operations and bytes; its
  bounds are the H100 peaks over those counts.
* ``run_one`` (8 envs, 8 rays x 8 px, 4 steps, 2 timed reps keyed by the
  cumulative ``fold_in``) gives the JAX ``run_one``'s checksum (float32
  sums in another order: rtol 1e-5) and config for four families.
* The CLI prints one JSON line with the JAX line's keys; ``run_suite``
  records a failing row and ends its line with ``summary``; with no card
  and no ``--device`` the bench exits before its first row.
* ``bench_scaling`` builds its envs through ``bench.build_env``, keys rep
  ``r`` by ``fold_in(key, r)`` and rounds its rates as the JAX script does.

The JAX bench is imported in-process with the compilation-cache settings
its import sets restored at once.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raycastworlds_tpu_torch import bench, bench_scaling
from raycastworlds_tpu_torch.parallel import rollout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_envs=8, num_rays=8, height_px=8, steps=4, reps=2)
RUN_ONE = {
    "single_room": dict(game="single_room"),
    "random_room": dict(game="random_room", reset_budget=4),
    "maze": dict(game="maze", reset_budget=4),
    "multi_player": dict(game="multi_player"),
}
# every SUITE row, then variants that no SUITE row sets
BUILDS = [(name, {k: v for k, v in kw.items() if k not in ("steps", "reps")})
          for name, kw in bench.SUITE] + [
    ("textured_checker", dict(texture="checker")),
    ("textured_brick_pal8", dict(texture="brick", obs="camera_pal8", num_rays=32)),
    ("random_room_flood_iters", dict(game="random_room", flood_iters=5, reset_budget=2)),
    ("pallas_locked_room", dict(game="locked_room", raycast="pallas")),
    ("analytic_multi_goal", dict(game="multi_goal", raycast="analytic")),
]


@pytest.fixture(scope="module")
def jbench():
    """The JAX ``bench.py`` as a module, the two JAX settings its import
    sets (a persistent compilation cache) put back as they were."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return module


@pytest.fixture(scope="module")
def jax_run_one(jbench):
    """game -> the JAX ``run_one`` row at TINY widths (one run each)."""
    cache = {}

    def get(game):
        if game not in cache:
            cache[game] = jbench.run_one(**TINY, **RUN_ONE[game])
        return cache[game]

    return get


def _jax_ppo_rows() -> list:
    """The PPO rows the JAX ``run_suite`` runs (a local list there)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "ppo_rows"):
            return eval(compile(ast.Expression(node.value), "bench.py", "eval"), {})
    raise AssertionError("bench.py has no ppo_rows")


def test_suite_and_ppo_rows_match_jax(jbench):
    assert bench.SUITE == jbench.SUITE
    assert [name for name, _ in bench.SUITE][:1] == ["flagship_single_room_4096"]
    assert len(bench.SUITE) == 17
    assert bench.PPO_ROWS == _jax_ppo_rows()
    assert len(bench.PPO_ROWS) == 3


@pytest.mark.parametrize("name,kw", BUILDS, ids=[n for n, _ in BUILDS])
def test_build_env_matches_jax(jbench, name, kw):
    kw = dict(kw, num_envs=4)
    env = bench.build_env(**kw, device="cpu")
    want = jbench.build_env(**kw)
    assert type(env.game).__name__ == type(want.game).__name__
    assert env.num_envs == want.num_envs == 4
    assert env.reset_budget == want.reset_budget
    assert type(env.cfg).__name__ == type(want.cfg).__name__
    assert dataclasses.asdict(env.cfg) == dataclasses.asdict(want.cfg)
    assert env.device == torch.device("cpu")


@pytest.mark.parametrize("name,kw", BUILDS, ids=[n for n, _ in BUILDS])
def test_roofline_counts_match_jax(jbench, name, kw):
    """The work counts equal the JAX bench's for the backend ``auto``
    resolves to on either device (the crossing formula for both the plain
    crossing and the crossing kernel); the bounds are the H100 peaks."""
    kw = dict(kw, num_envs=4)
    cfg = bench.build_env(**kw, device="cpu").cfg
    jcfg = jbench.build_env(**kw).cfg
    obs = kw.get("obs", "camera_u32")
    sps = 12345.6
    want = jbench._roofline(jcfg, obs, sps)
    for device_type in ("cpu", "cuda"):
        got = bench._roofline(cfg, obs, sps, device_type)
        assert list(got) == list(want)
        assert got["vpu_ops_per_step"] == want["vpu_ops_per_step"] > 0
        assert got["hbm_bytes_per_step"] == want["hbm_bytes_per_step"] > 0
        vpu = bench._H100_FP32_TOPS * 1e12 / got["vpu_ops_per_step"]
        hbm = bench._H100_HBM_GBPS * 1e9 / got["hbm_bytes_per_step"]
        assert got["sps_bound_vpu"] == round(vpu)
        assert got["sps_bound_hbm"] == round(hbm)
        assert got["binding"] == ("vpu" if vpu < hbm else "hbm")
        assert got["frac_of_roofline"] == round(sps / min(vpu, hbm), 4)
    assert (bench._H100_HBM_GBPS, bench._H100_FP32_TOPS) == (3350.0, 67.0)


@pytest.mark.parametrize("game", list(RUN_ONE))
def test_run_one_matches_jax(jax_run_one, game):
    got = bench.run_one(**TINY, **RUN_ONE[game], device="cpu")
    want = jax_run_one(game)
    assert list(got) == list(want)
    np.testing.assert_allclose(got["checksum"], want["checksum"], rtol=1e-5)
    assert np.isfinite(got["checksum"]) and got["value"] > 0
    assert len(got["times_s"]) == TINY["reps"]
    differ = {"device", "resolved_backend"}
    assert list(got["config"]) == list(want["config"])
    assert ({k: v for k, v in got["config"].items() if k not in differ}
            == {k: v for k, v in want["config"].items() if k not in differ})
    assert got["config"]["device"] == "cpu"
    assert got["config"]["resolved_backend"] == "crossing"
    for k in ("vpu_ops_per_step", "hbm_bytes_per_step"):
        assert got["roofline"][k] == want["roofline"][k]


def test_run_one_keys_reps_by_cumulative_fold_in(monkeypatch):
    """Warm-up on PRNGKey(1), then rep r on ``key = fold_in(key, r)``, the
    JAX bench's chain (bench.py:240), compared with ``jax.random``."""
    keys = []
    program = rollout.steps_per_second_program

    def recording(env, steps):
        run = program(env, steps)

        def wrapped(state, key):
            keys.append(np.asarray(key))
            return run(state, key)

        return wrapped

    monkeypatch.setattr(bench, "steps_per_second_program", recording)
    bench.run_one(num_envs=2, num_rays=8, height_px=8, steps=1, reps=3, device="cpu")
    key = jax.random.PRNGKey(1)
    want = [np.asarray(key)]
    for r in range(3):
        key = jax.random.fold_in(key, r)
        want.append(np.asarray(key))
    assert len(keys) == 4
    for got, exp in zip(keys, want):
        np.testing.assert_array_equal(got.astype(np.uint32), exp)


def test_cli_prints_one_json_line_with_the_jax_keys(jax_run_one):
    args = ["--device", "cpu", "--num-envs", "8", "--num-rays", "8", "--height-px", "8",
            "--steps", "4", "--reps", "2", "--texture", "xor", "--flood-iters", "3"]
    out = subprocess.run([sys.executable, "-m", "raycastworlds_tpu_torch.bench", *args],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    want = jax_run_one("single_room")
    assert list(row) == list(want)
    assert list(row["config"]) == list(want["config"])
    assert list(row["roofline"]) == list(want["roofline"])
    assert row["config"]["device"] == "cpu" and row["value"] > 0
    assert out.stderr.startswith("# single_room: ")


def test_run_suite_records_errors_and_ends_with_summary(capsys):
    rows = [("tiny_single_room", dict(TINY, reps=1)),
            ("tiny_random_room", dict(TINY, reps=1, game="random_room", reset_budget=4)),
            ("broken", dict(TINY, game="no_such_game"))]
    ppo_rows = [dict(name="tiny_ppo", num_envs=4, num_epochs=1)]
    result = bench.run_suite(rows, ppo_rows, device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert list(result)[-1] == "summary"
    assert [r["name"] for r in result["rows"]] == [
        "tiny_single_room", "tiny_random_room", "broken", "tiny_ppo"]
    assert result["rows"][2] == {"name": "broken",
                                 "error": "ValueError: unknown game no_such_game"}
    assert result["summary"]["broken"] == "ValueError: unknown game no_such_game"
    head = result["rows"][0]
    assert result["value"] == head["value"] > 0
    assert result["checksum"] == head["checksum"]
    assert result["summary"]["tiny_single_room"] == [
        head["value"], head["roofline"]["frac_of_roofline"]]
    ppo = result["rows"][3]
    assert ppo["metric"] == "ppo_env_steps_per_sec" and ppo["value"] > 0
    assert ppo["config"]["num_epochs"] == 1 and ppo["config"]["device"] == "cpu"
    assert result["summary"]["tiny_ppo"] == [ppo["value"]]
    assert [line.split(":")[0] for line in err.strip().splitlines()] == [
        "# tiny_single_room", "# tiny_random_room", "# broken", "# tiny_ppo"]


@pytest.mark.parametrize("args", [[], ["--num-envs", "8"]], ids=["suite", "row"])
def test_no_card_exits_before_any_row(args):
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    out = subprocess.run([sys.executable, "-m", "raycastworlds_tpu_torch.bench", *args],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "# " not in out.stderr and 'device="cpu"' in out.stderr


def test_run_suite_without_card_raises_before_any_row(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")

    def never(*args, **kwargs):
        raise AssertionError("a row ran")

    monkeypatch.setattr(bench, "run_one", never)
    monkeypatch.setattr(bench, "run_ppo_row", never)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.run_suite()


def test_bench_scaling_builds_through_bench():
    """``bench_scaling`` takes the bench's ``build_env``, textures and the
    flood budget included, as the JAX script takes ``bench.build_env``."""
    assert bench_scaling.build_env is bench.build_env
    env = bench_scaling.build_env("random_room", 2, 8, 8, texture="brick", flood_iters=3,
                                  device="cpu")
    assert env.cfg.wall_texture == "brick" and env.cfg.flood_iters == 3


def test_bench_scaling_keys_reps_by_fold_in(monkeypatch):
    """Rep r of ``measure`` runs on ``fold_in(PRNGKey(1), r)``, as the JAX
    script's (bench_scaling.py:38), after the warm-up on PRNGKey(1)."""
    keys = []

    def program(env, steps):
        def run(state, key):
            keys.append(np.asarray(key))
            return state, torch.zeros(())
        return run

    monkeypatch.setattr(bench_scaling, "steps_per_second_program", program)
    env = bench.build_env(num_envs=2, num_rays=8, height_px=8, device="cpu")
    bench_scaling.measure(env, 1, reps=3)
    base = jax.random.PRNGKey(1)
    want = [base] + [jax.random.fold_in(base, r) for r in range(3)]
    assert len(keys) == 4
    for got, exp in zip(keys, want):
        np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(exp))


def test_bench_scaling_rounds_its_rate(monkeypatch):
    monkeypatch.setattr(bench_scaling, "measure", lambda env, steps, reps=3: 12345.678)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = bench_scaling.main(["--device", "cpu", "--envs-per-device", "2",
                                     "--num-rays", "8", "--height-px", "8"])
    assert result["steps_per_sec_1dev"] == 12345.7
    assert json.loads(out.getvalue()) == result
