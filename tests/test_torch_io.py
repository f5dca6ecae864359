"""Port parity of dataset IO and the context summaries: the synthetic
identity dataset (the accuracy campaign's ground truth) drawn exactly as
the JAX package draws it, the `.dat` writer byte for byte, the reader
through the host C++ parser and through Python, ``parse_dat``, the
FRGC-format loader on files written here (the repo holds no FRGC data),
and the scheme and ciphertext summary strings."""

import numpy as np
import pytest

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.harness import accuracy as jacc
from image_matching_tpu.utils import io as jio
from image_matching_tpu.utils import native as jnative
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.harness import accuracy as tacc
from image_matching_tpu_torch.utils import carry
from image_matching_tpu_torch.utils import io as tio
from image_matching_tpu_torch.utils import native as tnative

import _native_lock
from _torch_parity import port_params, u32


@pytest.mark.parametrize("seed,n_ids,per_id,n_queries,dim,borderline", [
    (0, 7, 3, 4, 32, 0), (5, 8, 3, 5, 64, 0), (3, 9, 4, 3, 64, 2), (11, 5, 2, 6, 48, 3)])
def test_gen_identity_dataset_same_draws(seed, n_ids, per_id, n_queries, dim, borderline):
    want = jio.gen_identity_dataset(n_ids, per_id, n_queries, dim, seed=seed,
                                    borderline=borderline)
    got = tio.gen_identity_dataset(n_ids, per_id, n_queries, dim, seed=seed,
                                   borderline=borderline)
    assert got[0].shape == (n_ids * per_id + n_queries * borderline, dim)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


def _dat(tmp_path, name="d.dat", n=37, dim=24, seed=2):
    q, db = tio.gen_dataset(n, dim, seed=seed)
    path = tmp_path / name
    tio.write_dataset(str(path), q, db)
    return path, q, db


def test_write_dataset_byte_equal(tmp_path):
    path, q, db = _dat(tmp_path)
    jpath = tmp_path / "j.dat"
    jio.write_dataset(str(jpath), q, db)
    assert path.read_bytes() == jpath.read_bytes()


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "python"])
def test_read_dataset_equal(tmp_path, monkeypatch, native_lib):
    path, q, db = _dat(tmp_path)
    if native_lib and not _native_lock.available():
        pytest.skip("native library not built")
    if not native_lib:
        monkeypatch.setattr(tnative, "available", lambda: False)
    jq, jdb = jio.read_dataset(str(path), 24)
    tq, tdb = tio.read_dataset(str(path), 24)
    for w, g in ((jq, tq), (jdb, tdb), (q, tq), (db, tdb)):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("max_vals", [1, 25, 10_000])
def test_parse_dat_equal(tmp_path, max_vals):
    path, _, _ = _dat(tmp_path)
    if not _native_lock.available():
        pytest.skip("native library not built")
    want, got = jnative.parse_dat(str(path), max_vals), tnative.parse_dat(str(path), max_vals)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(want, got)
    assert tnative.parse_dat(str(tmp_path / "missing.dat"), 4) is None


def test_load_frgc_equal(tmp_path):
    dim, n, nq = 16, 9, 3
    db, db_ids, queries, q_ids = tio.gen_identity_dataset(3, 3, nq, dim, seed=4)
    files = {k: str(tmp_path / f"{k}.txt") for k in ("db", "q", "dbid", "qid")}
    np.savetxt(files["db"], np.concatenate([[n], db.ravel()]))  # N, then N*dim values
    np.savetxt(files["q"], queries.ravel())
    np.savetxt(files["dbid"], db_ids, fmt="%d")
    np.savetxt(files["qid"], q_ids, fmt="%d")
    args = (files["db"], files["q"], files["dbid"], files["qid"], dim)
    want, got = jacc.load_frgc(*args), tacc.load_frgc(*args)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(got[0], db)
    np.testing.assert_array_equal(got[1], db_ids)


@pytest.mark.parametrize("ring,depth,dnum", [(512, 2, 3), (512, 11, 3), (512, 6, 2)])
def test_scheme_and_cipher_summary_equal(ring, depth, dnum):
    params = SchemeParams.create(ring_dim=ring, mult_depth=depth, dnum=dnum, security="none")
    jctx = JCtx(params, seed=3)
    tctx = TCtx(port_params(params), seed=3, device="cpu")
    assert tctx.scheme_summary() == jctx.scheme_summary()
    z = np.random.default_rng(3).uniform(-1, 1, jctx.slots)
    jct = jctx.encrypt(z)
    cts = [jct, jctx.rescale(jctx.mul_relin(jct, jct))]
    for c in cts:
        tct = carry.ciphertext(u32(c.data), c.scale, device="cpu")
        assert tctx.cipher_summary(tct) == jctx.cipher_summary(c)
