"""Compute ops: channel, demodulation and the jnp decoder cores."""

from cuda_ldpc_tpu.ops import channel, demod, minsum, nb_decode

__all__ = ["channel", "demod", "minsum", "nb_decode"]
