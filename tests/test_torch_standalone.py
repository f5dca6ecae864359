"""The port stands alone and runs on the card by default.

Every module of image_matching_tpu_torch, and chip_smoke.py, imports in a
fresh interpreter whose import system refuses jax and the JAX package
(matched on the exact top-level name: image_matching_tpu_torch is
allowed).  CkksContext, NttPlan, MatchingProtocol.setup, the carry helpers,
the harnesses (the enrollment CLI too), serialization's loaders and
make_mesh take the card unless the caller asks for the CPU, and without a
GPU the default raises instead of carrying on on the CPU."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_matching_tpu_torch.ckks.context import CkksContext
from image_matching_tpu_torch.ckks.params import SchemeParams, root_of_unity
from image_matching_tpu_torch.harness import (accuracy, accuracy_campaign, enroll_cache, latency,
                                              run_artifact)
from image_matching_tpu_torch.matching.config import MatchConfig
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.ops.ntt import NttPlan
from image_matching_tpu_torch.parallel.sharded import make_mesh
from image_matching_tpu_torch.utils import carry, serial

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r'''
import importlib, importlib.abc, pkgutil, sys

REFUSED = ("jax", "jaxlib", "image_matching_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
import image_matching_tpu_torch

names = [m.name for m in pkgutil.walk_packages(image_matching_tpu_torch.__path__,
                                               "image_matching_tpu_torch.")]
assert {"image_matching_tpu_torch.parallel.sharded",
        "image_matching_tpu_torch.parallel.multihost",
        "image_matching_tpu_torch.harness.enroll_cache"} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

leaked = [m for m in sys.modules if m.split(".")[0] in REFUSED]
assert not leaked, leaked
print(len(names), "modules")
'''


def test_port_and_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 20


def test_entry_points_default_to_the_card():
    for fn in (CkksContext.__init__, NttPlan.__init__, MatchingProtocol.setup, carry.ciphertext,
               carry.base_db, carry.blind_db, carry.diag_db, carry.hers_db, latency.run,
               accuracy.run, run_artifact.run, accuracy_campaign.campaign, serial.load_context,
               serial.load_db, enroll_cache.enroll):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    params = SchemeParams.create(ring_dim=512, mult_depth=2, security="none")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        MatchingProtocol.setup(5, np.ones((4, 64)), MatchConfig(vector_dim=64), params=params)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        CkksContext(params)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        carry.ciphertext(np.zeros((2, 2, 512), np.uint32), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        NttPlan(512, params.q_primes[:1], [root_of_unity(params.q_primes[0], 1024)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh(devices=["cuda:0"] * 2)
    assert CkksContext(params, device="cpu").device == torch.device("cpu")
