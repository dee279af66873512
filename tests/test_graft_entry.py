"""The driver contract file must stay importable and runnable."""

import pathlib
import sys

import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import __graft_entry__ as ge  # noqa: E402


def test_entry_compiles():
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape[0] == args[0].shape[0]


def test_dryrun_multichip_8():
    ge.dryrun_multichip(8)
