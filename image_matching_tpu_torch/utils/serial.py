"""Serialization / checkpoint-resume (the port of
image_matching_tpu/utils/serial.py; the same files, so each package reads
what the other wrote).

The reference serializes the crypto context, all keys, and the encrypted
database to a `serial/` directory and can resume from it
(READ_FROM_SERIAL, reference include/config.h:26-27, src/main.cpp:122-285).
Here: ``params.json`` (the scheme parameters), ``keys.npz`` (s_eval,
s_eval_std, s_coeffs, pk_b, pk_a, relin_key, rotset_{i}_perms and
rotset_{i}_keys), ``rotmap.json`` (galois -> {set: row}), and per encrypted
DB ``{name}.json`` with ``{name}.npy``.  Residues are written as uint32 and
rotation permutations as int32, the JAX arrays' dtypes: the port's int32
residue storage is viewed as uint32, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..ckks.context import CkksContext
from ..ckks.params import SchemeParams
from ..matching import enrollers
from ..ops import modmath as mm
from . import carry


def save_context(ctx: CkksContext, dirpath: str):
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "params.json"), "w") as f:
        json.dump(dataclasses.asdict(ctx.params), f)
    arrays = {
        "s_eval": mm.to_numpy(ctx.s_eval),
        "s_eval_std": np.asarray(ctx._s_eval_std),
        "s_coeffs": np.asarray(ctx._s_coeffs),
        "pk_b": mm.to_numpy(ctx.pk_b),
        "pk_a": mm.to_numpy(ctx.pk_a),
        "relin_key": mm.to_numpy(ctx.relin_key),
    }
    for i, (perms, keys) in enumerate(ctx._rot_sets):
        arrays[f"rotset_{i}_perms"] = perms.cpu().numpy()
        arrays[f"rotset_{i}_keys"] = mm.to_numpy(keys)
    np.savez(os.path.join(dirpath, "keys.npz"), **arrays)
    with open(os.path.join(dirpath, "rotmap.json"), "w") as f:
        json.dump(
            {str(g): {str(s): r for s, r in locs.items()}
             for g, locs in ctx.rot_keys.items()},
            f,
        )


def load_context(dirpath: str, seed: int = 0, device="cuda") -> CkksContext:
    """A fresh ``CkksContext(params, seed)`` on ``device`` (the card unless
    the caller asks for the CPU) whose keys are then replaced by the saved
    ones, as the JAX package does."""
    with open(os.path.join(dirpath, "params.json")) as f:
        d = json.load(f)
    d["q_primes"] = tuple(d["q_primes"])
    d["sp_primes"] = tuple(d["sp_primes"])
    ctx = CkksContext(SchemeParams(**d), seed=seed, device=device)
    with open(os.path.join(dirpath, "rotmap.json")) as f:
        rot_keys = {int(g): {int(s): r for s, r in locs.items()}
                    for g, locs in json.load(f).items()}
    with np.load(os.path.join(dirpath, "keys.npz")) as z:
        n_sets = sum(1 for k in z.files if k.endswith("_perms"))
        carry.load_context_state(
            ctx, s_eval=z["s_eval"], pk_b=z["pk_b"], pk_a=z["pk_a"], relin_key=z["relin_key"],
            rot_sets=[(z[f"rotset_{i}_perms"], z[f"rotset_{i}_keys"]) for i in range(n_sets)],
            rot_keys=rot_keys)
        ctx._s_eval_std = z["s_eval_std"]
        ctx._s_coeffs = z["s_coeffs"]
    return ctx


_DB_CLASSES = {
    "base": enrollers.BaseDB,
    "hers": enrollers.HersDB,
    "blind": enrollers.BlindDB,
    "diag": enrollers.DiagDB,
}
_DB_LOADERS = {"base": carry.base_db, "hers": carry.hers_db, "blind": carry.blind_db,
               "diag": carry.diag_db}


def save_db(db, dirpath: str, name: str = "db"):
    os.makedirs(dirpath, exist_ok=True)
    kind = {v: k for k, v in _DB_CLASSES.items()}[type(db)]
    meta = {"kind": kind, "num_vectors": db.num_vectors, "scale": db.scale}
    if kind == "diag":
        meta["bsgs"] = db.bsgs
        meta["n1"] = db.n1
    with open(os.path.join(dirpath, f"{name}.json"), "w") as f:
        json.dump(meta, f)
    np.save(os.path.join(dirpath, f"{name}.npy"), mm.to_numpy(db.data))


def load_db(dirpath: str, name: str = "db", device="cuda"):
    """The saved DB on ``device`` (the card unless the caller asks for the
    CPU)."""
    with open(os.path.join(dirpath, f"{name}.json")) as f:
        meta = json.load(f)
    kind = meta["kind"]
    if kind not in _DB_LOADERS:
        raise ValueError(f"{name}.json: unknown DB kind {kind!r}")
    data = np.load(os.path.join(dirpath, f"{name}.npy"))
    extra = (meta["bsgs"], meta["n1"]) if kind == "diag" else ()
    return _DB_LOADERS[kind](data, meta["num_vectors"], meta["scale"], *extra, device=device)
