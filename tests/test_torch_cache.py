"""Port parity of the streamed store's on-disk caches at
tests/test_torch_streaming.py scale (ring 512, dim 64, 300 vectors: 2
groups), against the JAX package: the cache keys, the default directory,
the threshold, the c0 cache written by the native engines and loaded by
either package (byte-equal files, bit-equal stores, the context generator
left where a cached setup leaves it, and so equal rotation keys), resume
of an interrupted enrollment, a foreign cache, the encode cache, the
atomic writer and the port's enrollment CLI."""

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching import streaming as jstreaming
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.enrollers import diag_bsgs_n1
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.matching.vector_utils import normalize as jnormalize
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.harness import enroll_cache
from image_matching_tpu_torch.matching import enrollers, streaming
from image_matching_tpu_torch.matching.protocol import MatchingProtocol

import _native_lock
from _torch_parity import assert_same, jax_noise, jax_seeded_noise, port_cfg, port_params

ROOT = Path(__file__).resolve().parents[1]
DIM, NVEC = 64, 300
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2)
PARAMS = SchemeParams.create(
    ring_dim=512, mult_depth=compute_required_depth(5, CFG.comp_depth), security="none")
TCFG, TPARAMS = port_cfg(CFG), port_params(PARAMS)
ENROLL = {"diag": (jstreaming.enroll_diag_streamed, streaming.enroll_diag_streamed),
          "hers": (jstreaming.enroll_hers_streamed, streaming.enroll_hers_streamed)}


def _port_ctx(seed=7):
    return TCtx(TPARAMS, seed=seed, device="cpu", noise=jax_noise(PARAMS.sigma),
                seeded_noise=jax_seeded_noise(PARAMS.sigma))


def _db(seed=2):
    return dio.gen_dataset(NVEC, DIM, seed=seed)


def _needs_native():
    if not _native_lock.available():
        pytest.skip("native library not built")


def _files(d: Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _only_dir(root: Path) -> Path:
    [d] = [p for p in root.iterdir() if p.is_dir()]
    return d


def _rng_state(ctx):
    return ctx._rng.bit_generator.state


def _jax_native_cache(tmp_path, monkeypatch, layout="diag", sub="jax", db=None):
    """A complete c0 cache written by the JAX native engine under
    tmp_path/sub; returns (its directory, the JAX store)."""
    root = tmp_path / sub
    monkeypatch.setenv("IMTPU_STORE_DIR", str(root))
    js = ENROLL[layout][0](JCtx(PARAMS, seed=7), CFG, _db()[1] if db is None else db,
                           resident_budget=0, engine="native")
    return _only_dir(root), js


@pytest.mark.parametrize("layout,bsgs", [("diag", True), ("diag", False), ("hers", False)])
def test_cache_keys_equal_jax(tmp_path, monkeypatch, layout, bsgs):
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path))
    jctx, tctx = JCtx(PARAMS, seed=7), _port_ctx()
    _, db = _db()
    extra = (bsgs, diag_bsgs_n1(DIM) if bsgs else 1) if layout == "diag" else (False, 0)
    want = jstreaming._store_cache_path(jctx, CFG, db, 1234, *extra, layout=layout)
    assert streaming._store_cache_path(tctx, TCFG, db, 1234, *extra, layout=layout) == want
    assert Path(want).name.startswith(f"{layout}_{NVEC}_")
    want = jstreaming._enc_cache_path(jctx, CFG, db, extra, layout)
    assert streaming._enc_cache_path(tctx, TCFG, db, extra, layout) == want
    # the raw DB keys the cache: its normalized rows are another DB
    assert streaming._enc_cache_path(tctx, TCFG, jnormalize(db), extra, layout) != want


def test_cache_dir_default_and_off(monkeypatch):
    monkeypatch.delenv("IMTPU_STORE_DIR", raising=False)
    assert streaming._cache_dir() == jstreaming._cache_dir() == str(ROOT / ".dbcache")
    monkeypatch.setenv("IMTPU_STORE_DIR", "")
    assert streaming._cache_dir() is None and jstreaming._cache_dir() is None
    _, db = _db()
    assert streaming._store_cache_path(_port_ctx(), TCFG, db, 1, True, 8) is None
    assert streaming._enc_cache_path(_port_ctx(), TCFG, db, (True, 8), "diag") is None


class _Keyed(Exception):
    pass


def test_cache_off_below_threshold(tmp_path, monkeypatch):
    """With IMTPU_STORE_DIR unset no key is made below 2^16 vectors (and no
    file written), and one is at 2^16."""
    monkeypatch.delenv("IMTPU_STORE_DIR", raising=False)
    monkeypatch.setattr(streaming, "_cache_dir", lambda: str(tmp_path))
    keyed = []

    def spy(*a, **k):
        keyed.append(a[2].shape[0])
        raise _Keyed

    monkeypatch.setattr(streaming, "_store_cache_path", spy)
    ctx = TCtx(TPARAMS, seed=2, device="cpu")
    streaming.enroll_diag_streamed(ctx, TCFG, _db()[1], resident_budget=0, engine="device")
    assert keyed == [] and not any(tmp_path.iterdir())
    with pytest.raises(_Keyed):
        streaming.enroll_diag_streamed(ctx, TCFG, np.ones((1 << 16, DIM)), resident_budget=0,
                                       engine="native")
    assert keyed == [1 << 16]


@pytest.mark.parametrize("layout", ["diag", "hers"])
@pytest.mark.parametrize("engine", ["device", "native"])
def test_port_loads_jax_cache(tmp_path, monkeypatch, capsys, layout, engine):
    """A JAX-written c0 cache loads in the port, group for group equal to
    the JAX store, with no encryption, no draw from the generator and the
    JAX package's line on stderr."""
    _needs_native()
    _, js = _jax_native_cache(tmp_path, monkeypatch, layout)
    ctx = _port_ctx()

    def no_encrypt(*a, **k):
        raise AssertionError("a cached group was encrypted again")

    monkeypatch.setattr(ctx, "encrypt_seeded_batch_host", no_encrypt)
    monkeypatch.setattr(ctx, "encrypt_seeded_from_split", no_encrypt)
    state = _rng_state(ctx)
    capsys.readouterr()
    ts = ENROLL[layout][1](ctx, TCFG, _db()[1], resident_budget=0, engine=engine, verbose=True)
    told = capsys.readouterr().err
    assert ts.num_groups == js.num_groups == 2 and ts.resident == [False, False]
    for a, b in zip(js.groups, ts.groups):
        assert_same(a, b)
    assert _rng_state(ctx) == state
    ENROLL[layout][0](JCtx(PARAMS, seed=7), CFG, _db()[1], resident_budget=0, engine="device",
                      verbose=True)
    assert told == capsys.readouterr().err and told.startswith("# enrolled DB loaded from cache")


def test_cached_setup_rotation_keys_equal_jax(tmp_path, monkeypatch):
    """After a cached streamed setup (no draw for the groups) both packages
    generate equal rotation keys, and different ones from a fresh setup's."""
    _needs_native()
    _, db = _db()
    _jax_native_cache(tmp_path, monkeypatch, db=db)
    kw = dict(streamed=True, resident_budget=0, engine="device")
    jp = JProto.setup(5, db, CFG, ctx=JCtx(PARAMS, seed=7), **kw)
    tp = MatchingProtocol.setup(5, db, TCFG, ctx=_port_ctx(), **kw)
    assert tp.ctx.rot_keys == jp.ctx.rot_keys and len(tp.ctx._rot_sets) == 2
    for (jperm, jk), (tperm, tk) in zip(jp.ctx._rot_sets, tp.ctx._rot_sets):
        np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
        assert_same(jk, tk)
    for a, b in zip(jp.sender.store.groups, tp.sender.store.groups):
        assert_same(a, b)
    monkeypatch.setenv("IMTPU_STORE_DIR", "")
    fresh = MatchingProtocol.setup(5, db, TCFG, ctx=_port_ctx(), **kw)
    assert not np.array_equal(fresh.ctx._rot_sets[0][1].numpy(), tp.ctx._rot_sets[0][1].numpy())


@pytest.mark.parametrize("layout", ["diag", "hers"])
def test_port_cache_byte_equal_and_jax_loads_it(tmp_path, monkeypatch, layout):
    _needs_native()
    jdir, js = _jax_native_cache(tmp_path, monkeypatch, layout)
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path / "port"))
    ts = ENROLL[layout][1](_port_ctx(), TCFG, _db()[1], resident_budget=0, engine="native")
    tdir = _only_dir(tmp_path / "port")
    assert tdir.name == jdir.name
    assert _files(tdir) == _files(jdir)  # g0000.npy, g0001.npy, meta.json
    assert json.loads((tdir / "meta.json").read_text())["layout"] == layout
    jctx = JCtx(PARAMS, seed=7)
    state = _rng_state(jctx)
    loaded = ENROLL[layout][0](jctx, CFG, _db()[1], resident_budget=0, engine="device")
    assert _rng_state(jctx) == state  # loaded, not enrolled
    for a, b in zip(loaded.groups, ts.groups):
        assert_same(a, b)
    assert not any(p.name.endswith(".tmp") for p in tdir.iterdir())


def _tear(d: Path, how: str):
    """An interrupted run's tree: no meta.json and one file damaged."""
    (d / "meta.json").unlink()
    if how == "newest torn":  # tests/test_streaming.py's tree
        (d / "g0001.npy").write_bytes(b"torn write")
    elif how == "oldest torn":
        (d / "g0000.npy").write_bytes(b"torn write")
    elif how == "oldest foreign":
        np.save(d / "g0000.npy", np.zeros((DIM, 2, 512), np.uint32))


@pytest.mark.parametrize("how,reused", [("newest torn", 1), ("oldest torn", 0),
                                        ("oldest foreign", 0)])
def test_resume_equals_jax(tmp_path, monkeypatch, capsys, how, reused):
    """Each package resumes its own copy of one interrupted tree: equal
    stores, equal generator states after, the trusted groups served
    byte-identical, the same files and the same progress lines; then (for
    tests/test_streaming.py's tree) a setup loads the completed cache and
    decides."""
    _needs_native()
    query, db = _db()
    jdir, js = _jax_native_cache(tmp_path, monkeypatch, db=db)
    original = _files(jdir)
    _tear(jdir, how)
    tdir = tmp_path / "port" / jdir.name
    shutil.copytree(jdir, tdir)
    capsys.readouterr()
    jctx, tctx = JCtx(PARAMS, seed=7), _port_ctx()
    jr = jstreaming.enroll_diag_streamed(jctx, CFG, db, resident_budget=0, engine="native",
                                         verbose=True)
    jerr = capsys.readouterr().err.replace(str(tmp_path / "jax"), "ROOT")
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path / "port"))
    tr = streaming.enroll_diag_streamed(tctx, TCFG, db, resident_budget=0, engine="native",
                                        verbose=True)
    terr = capsys.readouterr().err.replace(str(tmp_path / "port"), "ROOT")
    assert terr == jerr and "# resuming enrollment: groups 0..0 cached" in terr
    assert _rng_state(jctx) == _rng_state(tctx) != _rng_state(_port_ctx())
    for a, b in zip(jr.groups, tr.groups):
        assert_same(a, b)
    for g in range(reused):
        np.testing.assert_array_equal(np.asarray(js.groups[g]), np.asarray(jr.groups[g]))
        assert (tdir / f"g{g:04d}.npy").read_bytes() == original[f"g{g:04d}.npy"]
    assert _files(tdir) == _files(jdir) and (tdir / "meta.json").exists()
    if how != "newest torn":
        return
    proto = MatchingProtocol.setup(5, db, TCFG, ctx=_port_ctx(), streamed=True,
                                   resident_budget=0, engine="native")
    for a, b in zip(tr.groups, proto.sender.store.groups):
        assert_same(a, b)
    qcts = proto.encrypt_query(query)
    assert proto.decrypt_membership(proto.membership(qcts)) is True
    assert proto.decrypt_index(proto.index(qcts)) == [0]


def test_gap_in_files_restarts(tmp_path, monkeypatch):
    """Files that do not run from g0000.npy without a gap are not reused:
    the store and the generator equal an uncached enrollment's."""
    _needs_native()
    jdir, _ = _jax_native_cache(tmp_path, monkeypatch)
    (jdir / "meta.json").unlink()
    (jdir / "g0000.npy").unlink()
    ctx, fresh = _port_ctx(), _port_ctx()
    store = streaming.enroll_diag_streamed(ctx, TCFG, _db()[1], resident_budget=0,
                                           engine="native")
    monkeypatch.setenv("IMTPU_STORE_DIR", "")
    want = streaming.enroll_diag_streamed(fresh, TCFG, _db()[1], resident_budget=0,
                                          engine="native")
    for a, b in zip(want.groups, store.groups):
        assert_same(a, b)
    assert _rng_state(ctx) == _rng_state(fresh)
    assert (jdir / "meta.json").exists()


def test_foreign_cache_reenrolls(tmp_path, monkeypatch):
    """A complete cache whose group files have another shape is not loaded:
    both packages enroll afresh on the device engine (one draw a group),
    bit-equal, and leave the cache as it was."""
    _needs_native()
    jdir, _ = _jax_native_cache(tmp_path, monkeypatch)
    np.save(jdir / "g0001.npy", np.zeros((DIM, PARAMS.num_limbs - 1, 512), np.uint32))
    before = _files(jdir)
    jctx, tctx = JCtx(PARAMS, seed=7), _port_ctx()
    js = jstreaming.enroll_diag_streamed(jctx, CFG, _db()[1], resident_budget=0,
                                         engine="device")
    ts = streaming.enroll_diag_streamed(tctx, TCFG, _db()[1], resident_budget=0,
                                        engine="device")
    for a, b in zip(js.groups, ts.groups):
        assert_same(a, b)
    assert _rng_state(jctx) == _rng_state(tctx) != _rng_state(_port_ctx())
    assert _files(jdir) == before


def test_encode_cache(tmp_path, monkeypatch):
    """The encode cache (the pinned engine's, run here through its
    pipeline on the CPU): files equal to the JAX encode of each group; a
    warm run reads them without normalizing the DB and encrypts the cold
    run's c0 from the same generator state; a file missing mid-run is
    encoded again (the rows normalized then) and saved byte-equal."""
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path))
    _, db = _db()
    shape = (DIM, PARAMS.num_limbs, 512)
    enc = streaming._enc_cache_path(_port_ctx(), TCFG, db, (False, 0), "hers")
    assert not streaming._enc_complete(enc, 2)

    def run(normalized):
        ctx = _port_ctx()
        store = streaming.HersStore(ctx, NVEC, ctx.fresh_scale, 1234)
        rows = streaming.normalize(db) if normalized else db
        return streaming._enroll_pinned(ctx, store, lambda r: enrollers.hers_group_vals(
            r, ctx.slots), rows, normalized, enc, shape, 0, False, False), ctx

    cold, cctx = run(True)
    assert streaming._enc_complete(enc, 2)
    jctx, jn = JCtx(PARAMS, seed=7), jnormalize(db)
    files = _files(Path(enc))
    for g in range(2):
        full = np.zeros((256, DIM))
        rows = jn[g * 256: (g + 1) * 256]
        full[: len(rows)] = rows
        want = np.stack(jctx.encode_split(np.ascontiguousarray(full.T)))
        np.testing.assert_array_equal(np.load(Path(enc) / f"g{g:04d}.npy"), want)

    calls = []
    real = streaming.normalize
    monkeypatch.setattr(streaming, "normalize", lambda x: calls.append(1) or real(x))
    warm, wctx = run(False)
    assert calls == []
    for a, b in zip(cold.groups, warm.groups):
        assert_same(a, b)
    assert _rng_state(wctx) == _rng_state(cctx)
    (Path(enc) / "g0001.npy").unlink()
    third, _ = run(False)
    assert calls == [1] and _files(Path(enc)) == files
    for a, b in zip(cold.groups, third.groups):
        assert_same(a, b)


def test_atomic_save_and_enc_complete(tmp_path):
    d = str(tmp_path / "enc")
    arr = np.arange(12, dtype=np.uint32).reshape(2, 2, 3)
    assert streaming._atomic_save(d, "g0000.npy", arr)
    assert np.array_equal(np.load(f"{d}/g0000.npy"), arr)
    assert (Path(d) / "g0000.npy").read_bytes() == _npy_bytes(tmp_path, arr)
    assert not streaming._enc_complete(d, 2) and not streaming._enc_complete(None, 1)
    assert streaming._atomic_save(d, "g0001.npy", arr)
    assert streaming._enc_complete(d, 2)
    assert not any(f.name.endswith(".tmp") for f in Path(d).iterdir())
    (tmp_path / "file").write_bytes(b"")  # a directory that cannot be made
    assert not streaming._atomic_save(str(tmp_path / "file" / "sub"), "g0000.npy", arr)


def _npy_bytes(tmp_path, arr):
    p = tmp_path / "plain.npy"
    np.save(p, arr)
    return p.read_bytes()


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_enroll_cache",
                                                  ROOT / "tools" / "enroll_cache.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_enroll_cli_matches_jax_tool(tmp_path, monkeypatch):
    """The port's enrollment CLI and the JAX package's
    tools/enroll_cache.py with the same arguments write the same
    directory, byte for byte."""
    _needs_native()
    args = ["--ring", "2048", "--log2n", "11"]
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr("sys.argv", ["enroll_cache.py", *args])
    _jax_tool().main()
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path / "port"))
    enroll_cache.main([*args, "--device", "cpu"])
    jdir, tdir = _only_dir(tmp_path / "jax"), _only_dir(tmp_path / "port")
    assert tdir.name == jdir.name and tdir.name.startswith("diag_2048_")
    assert _files(tdir) == _files(jdir)
    monkeypatch.setenv("IMTPU_STORE_DIR", "")
    with pytest.raises(SystemExit):
        enroll_cache.main([*args, "--device", "cpu"])
