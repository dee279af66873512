"""cuda_ldpc_tpu — JAX LDPC encode/decode + Monte-Carlo link-simulation framework.

A from-scratch JAX/XLA re-design with the capabilities of the CUDA reference
gsw4869/CUDA_LDPC (binary QC-LDPC min-sum simulator + non-binary GF(q) EMS/TMM
simulator), built around batched tensor programs:

- QC-LDPC codes kept first-class: base matrix of circulant shifts, messages shaped
  ``[batch, edge, Z]`` so the circulant permutation is a gather-free roll along Z.
- Decoders are pure jittable functions ``decode(llr, ...) -> (hard, ok, iters)``
  with on-device syndrome checks inside ``lax.while_loop`` (the reference instead
  round-trips decisions to the host every iteration).
- Monte-Carlo FER/BER sweeps shard codeword batches over a ``jax.sharding.Mesh``
  with ``psum``-reduced statistics and a global early-stop rule.

Layout:
    models/    code structures (binary QC + non-binary GF(q)) and decoders
    ops/       compute primitives: channel, demodulation, min-sum, EMS, TMM, QSPA
    parallel/  device meshes, sharded sweep driver, collective statistics
    utils/     parsers, GF table generation, config, reference-RNG, logging
"""

from cuda_ldpc_tpu.models.qc_binary import QCBinaryCode
from cuda_ldpc_tpu.models.nb_code import NBCode
from cuda_ldpc_tpu.utils import registry

__version__ = "0.1.0"

__all__ = ["QCBinaryCode", "NBCode", "registry", "__version__"]
