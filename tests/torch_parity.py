"""Helpers shared by the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU as its own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from efficientlo_net_torch.pretrained import variables_to_state_dict


def randomize_batch_stats(variables, seed=1):
    """Non-trivial eval-mode batch norm: running means ~ N(0, 0.05), running
    variances ~ U(0.5, 1.5), so every BN layer really normalizes."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(variables["batch_stats"])[0]
    leaves = [
        np.asarray(rng.uniform(0.5, 1.5, x.shape) if "var" in jax.tree_util.keystr(p)
                   else rng.normal(0.0, 0.05, x.shape), np.float32)
        for p, x in flat
    ]
    tree = jax.tree_util.tree_structure(variables["batch_stats"])
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_unflatten(tree, leaves)}


def near_identity_heads(params):
    """Pose heads that predict near-identity motion, as a trained network
    does on consecutive scans: q and t kernels scaled by 1e-2, q bias
    (1, 0, 0, 0), t bias 0.  Random heads predict poses of metres, and the
    three warps then re-project points onto crowded pixels whose winners a
    float32 rounding difference decides, so that l0 differs by 1e-2
    between any two float orders (two JAX compilations included)."""
    params = jax.tree_util.tree_map(lambda x: x, params)  # a copy of the dicts
    for name in ("l3_head", "head_l0", "head_l1", "head_l2"):
        for head, bias in (("q_head", [1.0, 0.0, 0.0, 0.0]), ("t_head", [0.0, 0.0, 0.0])):
            dense = params[name][head]["dense"]
            dense["kernel"] = dense["kernel"] * 0.01
            dense["bias"] = jnp.asarray(bias, jnp.float32)
    return params


def to_torch_module(module, variables):
    """Load Flax ``variables`` into the torch ``module`` through the weight
    bridge; strict, so every name must map one to one."""
    host = jax.tree_util.tree_map(np.asarray, variables)
    module.load_state_dict(variables_to_state_dict(host), strict=True)
    return module.eval()


def t(x):
    return torch.from_numpy(np.array(x))
