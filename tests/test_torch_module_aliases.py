"""Drop-in import parity of the port: every submodule a user imports from
the reference package resolves under ``datasketch_tpu_torch`` and exposes
the public names of the JAX package's alias (``Tpu*`` read as ``Torch*``);
``torch_lsh`` / ``torch_ensemble`` stand for ``tpu_lsh`` / ``tpu_ensemble``;
the package exports the JAX package's 30 names."""

import importlib
import types
import warnings

import pytest

import datasketch_tpu
import datasketch_tpu_torch
from tests.test_module_aliases import REFERENCE_MODULES

PAIRS = [(m, m) for m in REFERENCE_MODULES] + [("tpu_lsh", "torch_lsh"),
                                               ("tpu_ensemble", "torch_ensemble")]


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n, v in vars(module).items()
                 if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    return {n.replace("Tpu", "Torch") for n in names}


@pytest.mark.parametrize("jax_name,torch_name", PAIRS)
def test_submodule_imports_with_the_jax_alias_names(jax_name, torch_name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ours = importlib.import_module(f"datasketch_tpu_torch.{torch_name}")
        ref = importlib.import_module(f"datasketch_tpu.{jax_name}")
    assert _public(ours) == _public(ref)
    for name in _public(ours):
        assert hasattr(ours, name), name


def test_package_exports_the_jax_names():
    assert sorted(datasketch_tpu_torch.__all__) == sorted(_public(datasketch_tpu))
    assert len(datasketch_tpu_torch.__all__) == 30
    for name in datasketch_tpu_torch.__all__:
        assert getattr(datasketch_tpu_torch, name) is not None


def test_lshensemble_partition_alias_matches_jax():
    ours = importlib.import_module("datasketch_tpu_torch.lshensemble_partition")
    ref = importlib.import_module("datasketch_tpu.lshensemble_partition")
    sizes, counts = [1, 2, 3, 4, 5, 6, 7, 8], [5, 4, 3, 2, 2, 3, 4, 5]
    for num_part in (1, 2, 3, 5, 8):
        got = ours.optimal_partitions(sizes, counts, num_part)
        assert [tuple(map(int, p)) for p in got] == [
            tuple(map(int, p)) for p in ref.optimal_partitions(sizes, counts, num_part)]
