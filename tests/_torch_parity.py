"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
JAX package's encryption noise for the port, and numpy views of JAX and
port state so both packages can be compared bit for bit."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_matching_tpu_torch.ckks.params import SchemeParams as TParams
from image_matching_tpu_torch.matching.config import MatchConfig as TConfig
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.utils import carry

# Under pytest-xdist the workers share the machine's cores: each worker's
# torch takes its share instead of every core (oversubscribed thread pools
# slow every worker's plain-torch kernels).
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def port_params(params) -> TParams:
    """The port's own SchemeParams with the fields of the JAX package's."""
    return TParams(**dataclasses.asdict(params))


def port_cfg(cfg) -> TConfig:
    """The port's own MatchConfig with the fields of the JAX package's."""
    return TConfig(**dataclasses.asdict(cfg))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_noise(key, batch, n, sigma):
    # the noise draws of image_matching_tpu CkksContext._encrypt_impl
    kv, k0, k1 = jax.random.split(key, 3)
    v = jax.random.randint(kv, (batch, n), -1, 2, dtype=jnp.int32)
    e0 = jnp.round(jax.random.normal(k0, (batch, n), dtype=jnp.float32) * sigma).astype(jnp.int32)
    e1 = jnp.round(jax.random.normal(k1, (batch, n), dtype=jnp.float32) * sigma).astype(jnp.int32)
    return v, e0, e1


def jax_noise(sigma: float):
    """Noise callable for the port's CkksContext that reproduces the JAX
    package's encryption noise for the same numpy-drawn seed."""
    def fn(seed, batch, n):
        key = jax.random.key(int(seed))
        return tuple(np.asarray(x) for x in _jax_noise(key, batch, n, float(sigma)))
    return fn


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_seeded_noise(key, batch, n, sigma):
    # the noise draw of image_matching_tpu CkksContext._encrypt_seeded_dev:
    # one normal draw from the key, no split
    return jnp.round(jax.random.normal(key, (batch, n), dtype=jnp.float32) * sigma
                     ).astype(jnp.int32)


def jax_seeded_noise(sigma: float):
    """Seeded-noise callable for the port's CkksContext that reproduces the
    JAX package's seeded-encryption noise for the same numpy-drawn seed."""
    def fn(seed, batch, n):
        return np.asarray(_jax_seeded_noise(jax.random.key(int(seed)), batch, n, float(sigma)))
    return fn


def u32(x) -> np.ndarray:
    """Residues of either package as a uint32 numpy array."""
    if hasattr(x, "detach"):
        return tmm.to_numpy(x)
    return np.asarray(x).astype(np.uint32)


def carry_context(jctx, tctx):
    """Load the JAX context's keys into the port context."""
    carry.load_context_state(
        tctx, s_eval=u32(jctx.s_eval), pk_b=u32(jctx.pk_b), pk_a=u32(jctx.pk_a),
        relin_key=u32(jctx.relin_key),
        rot_sets=[(np.asarray(p), u32(k)) for p, k in jctx._rot_sets],
        rot_keys=jctx.rot_keys, pow2_set_idx=getattr(jctx, "_pow2_set_idx", None),
        pow2_rots=jctx._pow2_rots)


def protocol_pair(cfg, params, database, query, seed=7, approach=5):
    """The same protocol (HyDia unless ``approach`` says otherwise) set up
    in both packages from one seed, each with its own SchemeParams and
    MatchConfig of the same fields (the JAX package's are given): the port
    runs on the CPU and takes the JAX noise, so keys, DB and query agree bit
    for bit.  Returns the two protocols, the two query ciphertext lists and
    the JAX similarity-segment output (the jit that membership and index
    reuse) with its scale."""
    from image_matching_tpu.ckks.context import CkksContext as JCtx
    from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
    from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol as TProto

    jp = JProto.setup(approach, database, cfg, ctx=JCtx(params, seed=seed))
    tp = TProto.setup(approach, database, port_cfg(cfg),
                      ctx=TCtx(port_params(params), seed=seed, device="cpu",
                               noise=jax_noise(params.sigma)))
    jq, tq = jp.encrypt_query(query), tp.encrypt_query(query)
    qstack = jnp.stack([c.data for c in jq])
    jsim, meta = jp.sender._similarity_segment(qstack, jp.sender.db.data)
    return jp, tp, jq, tq, (np.asarray(jsim), meta["scale"])


def assert_same(a, b):
    """Bit-exact equality of two residue arrays (either package)."""
    a, b = u32(a), u32(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    bad = np.count_nonzero(a != b)
    assert bad == 0, f"{bad} of {a.size} residues differ"
