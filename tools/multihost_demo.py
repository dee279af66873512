"""Multi-process (multi-host) sweep demo over jax.distributed.

Worker mode (spawned once per "host"):
  python tools/multihost_demo.py worker <coordinator> <num_procs> <pid> [devices_per_proc]

A CPU-only demo: each process contributes ``devices_per_proc`` virtual CPU
devices; the mesh spans all processes' devices and the same SPMD sweep step
runs everywhere (the multi-host layout: one process per host,
`jax.distributed.initialize`, identical program).  Process 0 prints rows.

Launcher mode:
  python tools/multihost_demo.py launch [num_procs]
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def worker(coordinator: str, num_procs: int, pid: int, dev_per_proc: int) -> int:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={dev_per_proc}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_procs, process_id=pid)
    assert jax.process_count() == num_procs
    assert jax.device_count() == num_procs * dev_per_proc, jax.devices()

    from cuda_ldpc_tpu import config as cfg, sim
    from cuda_ldpc_tpu.parallel import get_mesh

    mesh = get_mesh()         # spans every process's devices
    simcfg = cfg.BinarySimConfig(
        code="J4_L24_Z96",
        decoder=cfg.BinaryDecoderConfig(max_iters=10, check="zero"),
        sweep=cfg.SweepConfig(snr_start=3.6, snr_step=0.4, snr_stop=4.0,
                              snr_type="ebn0", least_error_frames=2,
                              least_test_frames=32, max_frames=128,
                              display_step=10**9),
        batch_per_device=4)
    res = sim.run_binary_sweep(simcfg, mesh=mesh, quiet=pid != 0)

    if pid == 0:
        total = sum(r["frames"] for r in res.rows)
        print(f"MULTIHOST_OK procs={num_procs} devices={jax.device_count()} "
              f"frames={total}", flush=True)
    return 0


def launch(num_procs: int = 2, dev_per_proc: int = 4) -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", coord, str(num_procs), str(i),
         str(dev_per_proc)],
        stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
        stderr=subprocess.STDOUT) for i in range(num_procs)]
    out = procs[0].communicate(timeout=600)[0].decode()
    codes = [p.wait(timeout=600) for p in procs]
    print(out)
    assert all(c == 0 for c in codes), codes
    assert "MULTIHOST_OK" in out
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        sys.exit(worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                        int(sys.argv[5]) if len(sys.argv) > 5 else 4))
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    sys.exit(launch(n))
