"""The port's ``bench_ppo`` (``python -m raycastworlds_tpu_torch.bench_ppo``)
on the CPU at small widths: each variant (the default conv trunk,
``--trunk mlp --dtype bfloat16 --phases``, ``--recurrent --game maze``,
``--game multi_player --num-players 2``, ``--mesh`` at one rank) prints one
JSON line whose keys, and whose config's and phases' keys, are those of the
JAX ``bench_ppo.py`` (read from its source), with the config the flags
ask for; without ``--device`` it runs on the card and raises where there
is none."""

import ast
import contextlib
import io
import json
import os

import pytest
import torch

from raycastworlds_tpu_torch import bench_ppo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--num-envs", "8", "--rollout-steps", "4", "--updates", "1",
        "--num-rays", "8", "--height-px", "8", "--hidden", "16"]
VARIANTS = {
    "default": [],
    "mlp_bf16_phases": ["--trunk", "mlp", "--dtype", "bfloat16", "--phases"],
    "recurrent_maze": ["--recurrent", "--game", "maze"],
    "multi_player": ["--game", "multi_player", "--num-players", "2"],
    "mesh": ["--mesh", "--trunk", "patch", "--epochs", "1"],
}


def _dict_keys(node: ast.Dict) -> list:
    return [k.value for k in node.keys]


def jax_keys() -> dict:
    """The keys of the JAX script's line: the ``out`` dict literal, its
    ``config`` and the ``phases`` dict with the two keys added after it."""
    with open(os.path.join(ROOT, "bench_ppo.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Dict)):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id in ("out", "phases"):
                found[target.id] = node.value
            elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                  and target.value.id == "phases"):
                found.setdefault("phases_extra", []).append(target.slice.value)
    out = found["out"]
    config = out.values[_dict_keys(out).index("config")]
    return {
        "out": _dict_keys(out),
        "config": _dict_keys(config),
        "phases": _dict_keys(found["phases"]),
    }


def _run(args) -> dict:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = bench_ppo.main(TINY + args)
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1, out.getvalue()
    assert json.loads(lines[0]) == result
    return result


def test_jax_keys_are_read():
    keys = jax_keys()
    assert keys["out"] == ["metric", "value", "unit", "vs_baseline", "config", "seconds"]
    assert "n_devices" in keys["config"] and "num_players" in keys["config"]
    assert keys["phases"] == ["rollout_ms", "update_ms"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bench_ppo_prints_the_jax_keys(variant):
    args = VARIANTS[variant]
    got = _run(args)
    keys = jax_keys()
    phases = "--phases" in args
    assert list(got) == keys["out"] + (["phases"] if phases else [])
    assert list(got["config"]) == keys["config"]
    if phases:
        assert list(got["phases"]) == keys["phases"] + ["rollout_sps", "update_sps"]
        assert all(v > 0 for v in got["phases"].values())
    assert got["metric"] == "ppo_env_steps_per_sec" and got["value"] > 0
    assert got["vs_baseline"] == round(got["value"] / 1e7, 4)
    cfg = got["config"]
    assert cfg["game"] == (args[args.index("--game") + 1] if "--game" in args else "single_room")
    assert cfg["num_players"] == (2 if variant == "multi_player" else 1)
    assert (cfg["num_envs"], cfg["rollout_steps"], cfg["hidden"]) == (8, 4, 16)
    assert cfg["dtype"] == ("bfloat16" if "bfloat16" in args else "float32")
    assert cfg["trunk"] == (args[args.index("--trunk") + 1] if "--trunk" in args else "conv")
    assert cfg["recurrent"] == ("--recurrent" in args)
    assert cfg["num_epochs"] == (1 if "--epochs" in args else 2)
    assert cfg["device"] == "cpu" and cfg["n_devices"] == 1
    assert not torch.distributed.is_initialized()


def test_bench_ppo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench_ppo.main(TINY[2:])
