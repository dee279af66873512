"""The sim steps sharded over the 8-device CPU mesh: counters identical to
the same global batch on one device, and the compiled program moves no
batch-shaped array between devices (no all-gather whose shape carries the
global batch).  The same comparison runs on four GPUs in
``chip_smoke.py --cards 4``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_ldpc_tpu import config as cfg, sim
from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.parallel import get_mesh

PER_DEVICE = 2


def batch_gathers(hlo: str, batch: int) -> list[str]:
    """All-gather instructions whose result shape has the global batch."""
    out = []
    for line in hlo.splitlines():
        m = re.search(r"=\s*(.*?)\s+all-gather(?:-start)?\(", line)
        if m is None:
            continue
        for dims in re.findall(r"\w+\[([\d,]*)\]", m.group(1)):
            if batch in [int(d) for d in dims.split(",") if d]:
                out.append(line.strip())
                break
    return out


def test_batch_gathers_detects_gather():
    hlo = ("  %ag = f32[16,24,96]{2,1,0} all-gather(f32[2,24,96]{2,1,0} %x)"
           ", dimensions={0}\n  %s = s32[5]{0} all-reduce(s32[5]{0} %c)")
    assert batch_gathers(hlo, 16) == [hlo.splitlines()[0].strip()]
    assert batch_gathers(hlo, 32) == []


def _binary_cfg(schedule, n_dev, tx="zero", check="zero"):
    return cfg.BinarySimConfig(
        code="J4_L24_Z96", tx=tx,
        decoder=cfg.BinaryDecoderConfig(max_iters=6, schedule=schedule,
                                        check=check),
        batch_per_device=PER_DEVICE * 8 // n_dev)


def _nb_cfg(method, n_dev):
    return cfg.NBSimConfig(
        code="BDS.576.288.GF.64",
        decoder=cfg.NBDecoderConfig(method=method, max_iters=3),
        batch_per_device=PER_DEVICE * 8 // n_dev)


def _compare(make, args):
    """Build the step on 8 devices and on 1 with the same global batch;
    run both; check counters and the 8-device program's collectives."""
    outs = {}
    for n in (8, 1):
        fn, B = make(n, get_mesh(jax.devices()[:n]))
        assert B == PER_DEVICE * 8
        outs[n] = np.asarray(fn(*args))
        if n == 8:
            hlo = fn.lower(*args).compile().as_text()
            assert batch_gathers(hlo, B) == []
    np.testing.assert_array_equal(outs[8], outs[1])
    return outs[8]


KEY = jax.random.PRNGKey(4)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_binary_step_sharded_matches_one_device(schedule):
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    out = _compare(lambda n, mesh: sim.make_binary_step(
        code, _binary_cfg(schedule, n), mesh), (KEY, 0.55))
    assert out[1] <= PER_DEVICE * 8


def test_binary_random_tx_step_sharded_matches_one_device():
    code = QCBinaryCode.from_registry("J8_L24_Z96")

    def make(n, mesh):
        c = _binary_cfg("flooding", n, tx="random", check="syndrome")
        c.code = "J8_L24_Z96"
        return sim.make_binary_step(code, c, mesh)
    _compare(make, (KEY, 0.6))


def test_binary_packed_step_sharded_matches_one_device():
    code = QCBinaryCode.from_registry("J4_L24_Z96")
    B = PER_DEVICE * 8
    pid = jnp.asarray(np.arange(B, dtype=np.int32) % 2)
    sig = jnp.asarray(np.where(np.arange(B) % 2 == 0, 0.5, 0.6)
                      .astype(np.float32))
    out = _compare(lambda n, mesh: sim.make_binary_packed_step(
        code, _binary_cfg("flooding", n), 2, mesh), (KEY, sig, pid))
    assert out[:, 0].tolist() == [B // 2, B // 2]


@pytest.mark.parametrize("method", ["ems", "layered_qspa"])
def test_nb_step_sharded_matches_one_device(method):
    code = NBCode.from_registry("BDS.576.288.GF.64")
    _compare(lambda n, mesh: sim.make_nb_step(code, _nb_cfg(method, n),
                                              mesh), (KEY, 0.8))
