"""Port parity of serialization (utils/serial.py), mirroring
tests/test_io_serial.py at ring 512: the port writes the JAX package's
files (params.json, keys.npz, rotmap.json, {name}.json and {name}.npy),
with the same array names, dtypes and bits, each package loads what the
other saved, and a loaded context decrypts and rotates."""

import dataclasses

import numpy as np
import pytest

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.matching import enrollers as jenrollers
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.utils import io as jio
from image_matching_tpu.utils import serial as jserial
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import enrollers as tenrollers
from image_matching_tpu_torch.utils import carry
from image_matching_tpu_torch.utils import serial as tserial

from _torch_parity import assert_same, port_cfg, port_params, u32

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=3, security="none")
CFG = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8, alpha_depth=2)
SEED = 6
FILES = ("params.json", "rotmap.json")


def _keys(ctx):
    """Every key a context saves, as numpy arrays of the saved dtypes."""
    out = {"s_eval": u32(ctx.s_eval), "pk_b": u32(ctx.pk_b), "pk_a": u32(ctx.pk_a),
           "relin_key": u32(ctx.relin_key), "s_eval_std": np.asarray(ctx._s_eval_std),
           "s_coeffs": np.asarray(ctx._s_coeffs)}
    for i, (p, k) in enumerate(ctx._rot_sets):
        out[f"rotset_{i}_perms"] = np.asarray(p.cpu() if hasattr(p, "cpu") else p)
        out[f"rotset_{i}_keys"] = u32(k)
    return out


def _same_keys(a, b):
    ka, kb = _keys(a), _keys(b)
    assert ka.keys() == kb.keys()
    for k in ka:
        assert ka[k].dtype == kb[k].dtype and ka[k].shape == kb[k].shape, k
        np.testing.assert_array_equal(ka[k], kb[k], err_msg=k)
    assert a.rot_keys == b.rot_keys


@pytest.fixture(scope="module")
def ctxs():
    """The same context in both packages (one seed draws the same keys),
    with the power-of-two rotation set and a second set."""
    jctx, tctx = JCtx(PARAMS, seed=SEED), TCtx(port_params(PARAMS), seed=SEED, device="cpu")
    for c in (jctx, tctx):
        c.gen_power_of_two_rotation_keys()
        c.gen_rotation_keys([3, 5, -7])
    _same_keys(jctx, tctx)
    return jctx, tctx


@pytest.fixture(scope="module")
def saved(ctxs, tmp_path_factory):
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jserial.save_context(ctxs[0], str(jdir))
    tserial.save_context(ctxs[1], str(tdir))
    return jdir, tdir


def test_context_files_equal(saved):
    jdir, tdir = saved
    for name in FILES:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    jz, tz = np.load(jdir / "keys.npz"), np.load(tdir / "keys.npz")
    assert tz.files == jz.files
    for k in jz.files:
        assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape, k
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)


def test_port_loads_jax_context(ctxs, saved):
    jctx, tctx = ctxs
    loaded = tserial.load_context(str(saved[0]), device="cpu")
    assert dataclasses.asdict(loaded.params) == dataclasses.asdict(tctx.params)
    _same_keys(loaded, jctx)


def test_jax_loads_port_context(ctxs, saved):
    loaded = jserial.load_context(str(saved[1]))
    _same_keys(loaded, ctxs[1])


@pytest.mark.parametrize("side", ["port", "jax"])
def test_loaded_context_decrypts_and_rotates(ctxs, saved, side):
    """The port loads either package's files; a ciphertext of the saved
    context decrypts under the loaded one, and rotates by 2."""
    jctx, tctx = ctxs
    loaded = tserial.load_context(str(saved[0] if side == "jax" else saved[1]), device="cpu")
    z = np.random.default_rng(SEED).uniform(-1, 1, tctx.slots)
    ct = tctx.encrypt(z)
    np.testing.assert_allclose(loaded.decrypt(ct), z, atol=1e-4)
    np.testing.assert_allclose(loaded.decrypt(loaded.rotate(ct, 2)), np.roll(z, -2), atol=1e-4)


@pytest.fixture(scope="module")
def dbs(ctxs):
    """The four DB layouts enrolled by the JAX package and carried into
    the port, and HyDia's enrolled by the port itself."""
    jctx, tctx = ctxs
    _, db = jio.gen_dataset(20, CFG.vector_dim, seed=3)
    out = {}
    for kind, enroll, to_port in (("base", "enroll_base", carry.base_db),
                                  ("hers", "enroll_hers", carry.hers_db),
                                  ("blind", "enroll_blind", carry.blind_db),
                                  ("diag", "enroll_diag", carry.diag_db)):
        j = getattr(jenrollers, enroll)(jctx, CFG, db)
        extra = (j.bsgs, j.n1) if kind == "diag" else ()
        out[kind] = (j, to_port(u32(j.data), j.num_vectors, j.scale, *extra, device="cpu"))
    out["diag_port"] = (None, tenrollers.enroll_diag(tctx, port_cfg(CFG), db))
    return out


def _same_db(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in ("num_vectors", "scale", "bsgs", "n1"):
        assert getattr(a, f, None) == getattr(b, f, None), f
    assert_same(a.data, b.data)


@pytest.mark.parametrize("kind", ["base", "hers", "blind", "diag"])
def test_db_files_equal_and_cross_load(dbs, tmp_path, kind):
    jdb, tdb = dbs[kind]
    jserial.save_db(jdb, str(tmp_path / "j"), kind)
    tserial.save_db(tdb, str(tmp_path / "t"), kind)
    for ext in ("json", "npy"):
        assert (tmp_path / "t" / f"{kind}.{ext}").read_bytes() == \
            (tmp_path / "j" / f"{kind}.{ext}").read_bytes(), ext
    got = tserial.load_db(str(tmp_path / "j"), kind, device="cpu")
    assert isinstance(got, type(tdb))
    _same_db(got, tdb)
    _same_db(jserial.load_db(str(tmp_path / "t"), kind), jdb)


def test_port_db_round_trip(dbs, tmp_path):
    """A DB the port enrolled comes back bit-equal, and the JAX package
    reads it."""
    tdb = dbs["diag_port"][1]
    tserial.save_db(tdb, str(tmp_path), "hydia")
    _same_db(tserial.load_db(str(tmp_path), "hydia", device="cpu"), tdb)
    assert_same(jserial.load_db(str(tmp_path), "hydia").data, tdb.data)
