"""The port's mesh helpers and shard-aware draws, in one process.

``make_mesh`` and its errors (as the JAX package's ``test_sharding.py``),
``local_batch_size`` and ``shard_range`` against the JAX mesh's, shard and
gather round trips of env states and of the feedforward params' mp shards,
and every shard-aware draw of ``rng`` equal to its slice of the global
draw for 1, 2, 3 and 4 ranks, bit for bit (``categorical`` also against
``jax.random.categorical``).  The multi-rank paths are in
``test_torch_distributed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raycastworlds_tpu_torch as rt
from raycastworlds_tpu.parallel import mesh as jmesh
from raycastworlds_tpu_torch import rng
from raycastworlds_tpu_torch.parallel import mesh as mesh_lib
from raycastworlds_tpu_torch.parallel import ppo
from raycastworlds_tpu_torch.parallel.params import actor_critic_from_flax


def cpu_mesh(dp, mp=1, dp_index=0, mp_index=0):
    """A rank's place on a (dp, mp) mesh, without a process group (index
    arithmetic only)."""
    return mesh_lib.Mesh(dp, mp, dp_index, mp_index, torch.device("cpu"))


def test_make_mesh_one_process():
    m = mesh_lib.make_mesh(devices=["cpu"])
    assert (m.dp, m.mp, m.rank, m.device) == (1, 1, 0, torch.device("cpu"))
    assert m.shape == {"dp": 1, "mp": 1}
    assert m.dp_group is None and m.mp_group is None
    x = torch.arange(6)
    assert m.all_reduce(x) is x and torch.equal(m.gather(x), x)  # identity
    with pytest.raises(ValueError, match=r"dp\*mp=6 != #ranks=1"):
        mesh_lib.make_mesh(dp=3, mp=2, devices=["cpu"])
    with pytest.raises(ValueError, match="not divisible by mp=2"):
        mesh_lib.make_mesh(mp=2, devices=["cpu"])
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        mesh_lib.make_mesh(devices=["cpu", "cpu"])
    # the JAX mesh refuses the same shape
    with pytest.raises(ValueError):
        jmesh.make_mesh(dp=3, mp=2)


def test_make_mesh_refuses_more_ranks_than_cards(monkeypatch):
    """Without ``devices`` each rank takes a card of its own; more ranks on
    the host than cards raise instead of sharing one unasked."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="pass devices="):
        mesh_lib.make_mesh()


@pytest.mark.parametrize("dp,mp", [(1, 1), (2, 1), (4, 2), (8, 1)])
def test_local_batch_size_and_shard_range(dp, mp):
    jm = jmesh.make_mesh(dp=dp, mp=mp, devices=jax.devices()[:dp * mp])
    assert mesh_lib.local_batch_size(16, cpu_mesh(dp, mp)) == jmesh.local_batch_size(16, jm)
    rows = [mesh_lib.shard_range(16, cpu_mesh(dp, mp, i)) for i in range(dp)]
    assert rows == [(i * 16 // dp, (i + 1) * 16 // dp) for i in range(dp)]
    if dp > 1:
        with pytest.raises(ValueError, match=f"batch 17 not divisible by dp={dp}"):
            mesh_lib.local_batch_size(17, cpu_mesh(dp, mp))
        with pytest.raises(ValueError):
            jmesh.local_batch_size(17, jm)


def test_mesh_rank_is_row_major():
    """rank = dp_index * mp + mp_index, as the JAX mesh reshapes its device
    list (``np.asarray(devs).reshape(dp, mp)``)."""
    jm = jmesh.make_mesh(dp=4, mp=2, devices=jax.devices()[:8])
    for i in range(4):
        for j in range(2):
            assert cpu_mesh(4, 2, i, j).rank == jm.devices[i, j].id


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_shard_env_state_round_trip(dp):
    """The ranks' rows, side by side, are the global state; every leaf,
    the optional ones included."""
    cfg = rt.MultiGoalConfig(num_rays=8, height_camera_view_pu=8)
    env = rt.Env(rt.MultiGoalRoom(cfg), num_envs=12, device="cpu", reset_budget=2)
    state, _ = env.reset(rng.PRNGKey(3))
    state = env.step(state, env.sample_action(rng.PRNGKey(4))).state
    shards = [mesh_lib.shard_env_state(state, cpu_mesh(dp, 1, i)) for i in range(dp)]
    for k, v in state.leaves().items():
        assert all(s.leaves()[k].shape[0] == 12 // dp for s in shards), k
        assert torch.equal(torch.cat([s.leaves()[k] for s in shards]), v), k
    one = mesh_lib.make_mesh(devices=["cpu"])
    back = mesh_lib.gather_env_state(mesh_lib.shard_env_state(state, one), one)
    assert all(torch.equal(back.leaves()[k], v) for k, v in state.leaves().items())


@pytest.mark.parametrize("trunk", ["conv", "mlp"])
def test_param_shards(trunk):
    """The feedforward params' mp shards (carried from flax with a mesh):
    trunk weight rows and bias, the heads' weight columns, the rest whole;
    the shards side by side are the full params.  The recurrent net's
    params never split."""
    flax_params = ppo_flax_params(trunk)
    full = actor_critic_from_flax(flax_params)
    shards = [actor_critic_from_flax(flax_params, mesh=cpu_mesh(1, 2, 0, j)) for j in range(2)]
    split = {"trunk.weight": 0, "trunk.bias": 0, "policy.weight": 1, "value.weight": 1}
    for k, v in full.items():
        assert ppo.param_shard_dim(k) == split.get(k), k
        if k in split:
            assert shards[0][k].shape[split[k]] == v.shape[split[k]] // 2
            assert torch.equal(torch.cat([s[k] for s in shards], split[k]), v), k
        else:
            assert all(torch.equal(s[k], v) for s in shards), k


def ppo_flax_params(trunk):
    from raycastworlds_tpu.parallel import ppo as jppo

    net = jppo.ActorCritic(hidden=32, trunk=trunk)
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1)))
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# Shard-aware draws
# ---------------------------------------------------------------------------

N = 12  # divides by 1, 2, 3 and 4 ranks


def draws(key, shard=None):
    """Each draw of the engine, global (shard None) or a rank's rows."""
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(N, 5)).astype(np.float32))
    logits_p = torch.from_numpy(
        np.random.default_rng(1).normal(size=(N, 2, 4)).astype(np.float32))
    rows = slice(None) if shard is None else slice(*shard)
    return {
        "split": rng.split(key, N, shard),
        "randint": rng.randint(key, (N,), 0, 4, shard),
        "randint_array_bounds": rng.randint(key, (N, 2), [1, 1], [7, 15], shard),
        "randint_players": rng.randint(key, (N, 3), 0, 4, shard),
        "uniform": rng.uniform(key, (N, 3), shard=shard),
        "bernoulli": rng.bernoulli(key, 0.3, (N,), shard),
        "categorical": rng.categorical(key, logits[rows], shard),
        "categorical_players": rng.categorical(key, logits_p[rows], shard),
        "randint_t_b": rng.randint(key, (5, N), 0, 4, shard, axis=1),
    }


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_shard_draws_equal_the_global_slices(ranks):
    key = rng.PRNGKey(11)
    full = draws(key)
    parts = [draws(key, (i * N // ranks, (i + 1) * N // ranks)) for i in range(ranks)]
    for name, want in full.items():
        axis = 1 if name == "randint_t_b" else 0
        assert parts[0][name].shape[axis] == N // ranks, name
        got = torch.cat([p[name] for p in parts], axis)
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_shard_categorical_matches_jax(ranks):
    """Each rank's actions are its rows of ``jax.random.categorical`` over
    the global logits (the Gumbel noise of its rows only)."""
    logits = np.random.default_rng(2).normal(size=(N, 2, 4)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(9), jnp.asarray(logits)))
    for i in range(ranks):
        lo, hi = i * N // ranks, (i + 1) * N // ranks
        got = rng.categorical(rng.PRNGKey(9), torch.from_numpy(logits[lo:hi]), (lo, hi))
        np.testing.assert_array_equal(got.numpy(), want[lo:hi])


def test_shard_out_of_range_raises():
    with pytest.raises(ValueError, match="outside axis 0"):
        rng.randint(rng.PRNGKey(0), (4,), 0, 3, (2, 6))
