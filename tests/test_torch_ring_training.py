"""Parity of the port's W-axis ring in training with the JAX package, on the CPU.

The port runs in one spawned gloo job of 8 ranks (``torch_parallel_cases``'s
"ring_train": (2, R) ``DeviceMesh``es for rings of 2, 3 and 4, (1, 5) for a
ring of 5, a ring of 4 as a process group and a (2, 2) mesh for the
network), while this process computes the JAX references on the
conftest's 8 virtual CPU devices.  Tolerances:

* the ring functions' gradients in xyz and feats
  (``ring_select_and_group_replicated`` unfused, through ``shard_w``, the
  halo exchange and ``gather_w``): within GRAD_SCALE_ATOL = 1e-6 of the
  gradient's largest entry, against ``jax.grad`` through JAX's
  ``ring_select_and_group`` on ``ring_mesh(2, R)`` and against the port's
  unsharded ``select_and_group(fused=False)`` (JAX's ring against its own
  unsharded select gives 0.0); the groups equal the unsharded ones exactly
  and every rank's gradients are bit-equal.  A ``gather_w`` whose backward
  summed over the ranks would give R times the gradient;
* the same backward emulated in one process on every rank's widened block
  (``torch_parallel_cases.train_block_grads``, which ``chip_smoke.py``
  phase 11d runs on the card): groups exact, gradients within
  GRAD_SCALE_ATOL of their scale;
* the tiny network in training with its level-0 select on a ring of 4 and
  on a (2, 2) mesh, against JAX's ``jax.grad`` of the loss over
  ``model.apply(training=True, ring_mesh=ring_mesh(2, 4))`` with
  near-identity pose heads, dropout 0 and scan order
  (``test_torch_parallel._jax_grad_fns``): ``test_torch_train.py``'s
  whole-network tolerances (losses atol 1e-5 and rtol 1e-5, batch
  statistics rtol 1e-4 and atol 1e-5, each gradient within 1e-4 of the
  larger of its largest entry and 1e-2 of the largest gradient);
* the same network against the port's unsharded training forward on the
  same generator seed, in scan order with dropout 0 and with the tiny
  config's dropout and scan permutations: losses, level outputs, batch
  statistics and gradients bit-equal (the ring's groups are the unsharded
  groups, and no parameter gradient passes the ring), and every rank's
  gradients bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from efficientlo_net_tpu.parallel import ring as JR
from tests.test_ring import ring_mesh
# jax_tiny is a module fixture of the parallel tests, used here too
from tests.test_torch_parallel import (_flat, _jax_grad_fns, jax_tiny,  # noqa: F401
                                       write_train_weights)
from tests.test_torch_train import FEAT_TOL, LOSS_ATOL, assert_grads_close, flat_stats

GRAD_SCALE_ATOL = 1e-6
WORLD = 8


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, jax_tiny):
    out = tmp_path_factory.mktemp("ring_train")
    write_train_weights(out, jax_tiny[2])
    runs = cases.Spawned(out, {"ring_train": WORLD})
    yield runs
    runs.close()


def _unsharded(name):
    """The port's unsharded groups and their autograd gradients on a
    GRAD_CASES case."""
    _, _, kernel, k, distance, cs, mode = cases.GRAD_CASES[name]
    xyz, feats, perm, up = cases.grad_inputs(name)
    args = (torch.from_numpy(xyz), torch.from_numpy(feats), kernel, k, distance, cs, mode,
            None if perm is None else torch.from_numpy(perm))
    return [x.numpy() for x in cases.unsharded_group_grads(args, torch.from_numpy(up))]


def _jax_ring_grads(name, ring_size):
    """``jax.grad`` of sum(upstream * groups) through JAX's
    ``ring_select_and_group`` on ``ring_mesh(2, ring_size)``."""
    _, _, kernel, k, distance, cs, mode = cases.GRAD_CASES[name]
    xyz, feats, perm, up = cases.grad_inputs(name)
    select = functools.partial(JR.ring_select_and_group, kernel_size=kernel, k=k,
                               distance=distance, mesh=ring_mesh(2, ring_size),
                               center_stride=cs, mode=mode,
                               perm=None if perm is None else jnp.asarray(perm))

    def loss(x, f):
        gx, gf, _ = select(x, f)
        return jnp.sum(jnp.concatenate([gx, gf], -1) * up)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(xyz), jnp.asarray(feats))]


def _assert_scale_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_SCALE_ATOL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("ring_size", cases.GRAD_RINGS)
@pytest.mark.parametrize("name", list(cases.GRAD_CASES))
def test_ring_select_and_group_gradients_match_jax(spawned, name, ring_size):
    want_x, want_f = _jax_ring_grads(name, ring_size)
    plain_groups, plain_x, plain_f = _unsharded(name)
    _assert_scale_close(plain_x, want_x, "unsharded port xyz")
    _assert_scale_close(plain_f, want_f, "unsharded port feats")
    ranks = (2 if 2 * ring_size <= WORLD else 1) * ring_size
    first = spawned.result("ring_train", 0)["grads"][name, ring_size]
    for rank in range(ranks):
        groups, got_x, got_f = spawned.result("ring_train", rank)["grads"][name, ring_size]
        np.testing.assert_array_equal(groups, plain_groups, err_msg=f"rank {rank}")
        _assert_scale_close(got_x, want_x, f"rank {rank} xyz")
        _assert_scale_close(got_f, want_f, f"rank {rank} feats")
        np.testing.assert_array_equal(got_x, first[1])
        np.testing.assert_array_equal(got_f, first[2])
    assert np.abs(want_f).max() > 0 and np.abs(want_x).max() > 0


@pytest.mark.parametrize("ring_size", (3, 5))
@pytest.mark.parametrize("name", list(cases.GRAD_CASES))
def test_block_gradients_fold_onto_the_unsharded_gradient(name, ring_size):
    """The backward of every rank's block, emulated in one process: each
    block's gather gradient folded onto the sectors by ``fold_halo_grad``
    gives the unsharded gradient (the check phase 11d makes on the card)."""
    _, _, kernel, k, distance, cs, mode = cases.GRAD_CASES[name]
    xyz, feats, perm, up = cases.grad_inputs(name)
    args = (torch.from_numpy(xyz), torch.from_numpy(feats), kernel, k, distance, cs, mode,
            None if perm is None else torch.from_numpy(perm))
    up = torch.from_numpy(up)
    groups, grad_x, grad_f = cases.train_block_grads(args, ring_size, up,
                                                     cases.unsharded_group_grads(args, up))
    assert groups == 0.0
    assert grad_x <= GRAD_SCALE_ATOL and grad_f <= GRAD_SCALE_ATOL, (grad_x, grad_f)


@pytest.fixture(scope="module")
def jax_ring_step(jax_tiny):
    """JAX's loss gradient, new statistics and metrics of the tiny network
    in training with ``ring_mesh(2, 4)`` on the RING_TRAIN_SEED batch."""
    _, ring_fn, on_seed = _jax_grad_fns(jax_tiny, ring=ring_mesh(2, 4))
    grads, (stats, metrics) = on_seed(ring_fn, cases.RING_TRAIN_SEED)
    return _flat(grads), stats, metrics


@pytest.mark.parametrize("which", ["ring4", "mesh22"])
def test_ring_training_matches_jax_ring_mesh(spawned, jax_ring_step, which):
    grads, stats, metrics = jax_ring_step
    for rank in range(4):
        got = spawned.result("ring_train", rank)["network"][which, False]
        for k in metrics:
            np.testing.assert_allclose(got["metrics"][k], float(metrics[k]), atol=LOSS_ATOL,
                                       rtol=1e-5, err_msg=f"rank {rank} {k}")
        assert_grads_close(got["grads"], grads)
        want_stats = flat_stats(stats)
        assert got["stats"].keys() == want_stats.keys()
        for k in want_stats:
            np.testing.assert_allclose(got["stats"][k], want_stats[k], err_msg=f"rank {rank} {k}",
                                       **FEAT_TOL)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("which", ["ring4", "mesh22"])
def test_ring_training_equals_unsharded_training(spawned, which, stochastic):
    want = spawned.result("ring_train", 0)["network"]["unsharded", stochastic]
    for rank in range(4):
        got = spawned.result("ring_train", rank)["network"][which, stochastic]
        assert got["metrics"] == want["metrics"], rank
        for key in ("q", "t"):
            for lvl, (g, w) in enumerate(zip(got[key], want[key])):
                np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} {key} l{lvl}")
        for part in ("grads", "stats"):
            assert got[part].keys() == want[part].keys()
            for k, w in want[part].items():
                np.testing.assert_array_equal(got[part][k], w, err_msg=f"rank {rank} {k}")
