"""Random number generation: exact pcg32 + tea/lcg counter RNG, fully batched.

Two generators, mirroring the reference's two device paths:

- **pcg32** — bit-exact reimplementation of the pcg32 used by the reference CPU
  sampler (`ext/pcg32/pcg32.h`, seeded per block in `src/samplers/independent.cpp`).
  64-bit state is carried as two uint32 limbs so kernels never need x64 mode;
  the multiply/add is done in 16-bit limb arithmetic. Validated bit-for-bit
  against a pure-Python integer model in tests/test_rng.py.
- **tea/lcg** — the counter-based hash RNG of the reference GPU path
  (`include/nori/optix/cuda/sutil/random.h:34-68`): `tea<4>(pixel, sample)`
  seeds a 32-bit LCG. Stateless per lane → ideal for ray wavefronts.

All functions are shape-polymorphic: state arrays have a trailing dim of 2
(pcg32: [state_hi, state_lo] ... inc is passed alongside) and any batch shape.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_U32 = jnp.uint32

PCG32_DEFAULT_STATE = (0x853C49E6, 0x748FEA9B)  # 0x853c49e6748fea9bULL
PCG32_DEFAULT_STREAM = (0xDA3E39CB, 0x94B95BDB)  # 0xda3e39cb94b95bdbULL
PCG32_MULT = (0x5851F42D, 0x4C957F2D)  # 0x5851f42d4c957f2dULL


def _u32(x):
    return jnp.asarray(x, _U32)


def _mul32_wide(a: jnp.ndarray, b: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full 32x32→64 multiply via 16-bit limbs. Returns (hi, lo) uint32."""
    a0 = a & _u32(0xFFFF)
    a1 = a >> _u32(16)
    b0 = b & _u32(0xFFFF)
    b1 = b >> _u32(16)
    t = a0 * b0
    u = a1 * b0 + (t >> _u32(16))
    v = a0 * b1 + (u & _u32(0xFFFF))
    hi = a1 * b1 + (u >> _u32(16)) + (v >> _u32(16))
    lo = (v << _u32(16)) | (t & _u32(0xFFFF))
    return hi, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    carry = (lo < al).astype(_U32)
    hi = ah + bh + carry
    return hi, lo


def _mul64_lo(ah, al, bh, bl):
    """Low 64 bits of a 64x64 multiply; operands/result as (hi, lo) uint32."""
    hi, lo = _mul32_wide(al, bl)
    hi = hi + al * bh + ah * bl
    return hi, lo


class Pcg32State(NamedTuple):
    """Batched pcg32: every field uint32 with identical batch shape."""

    state_hi: jnp.ndarray
    state_lo: jnp.ndarray
    inc_hi: jnp.ndarray
    inc_lo: jnp.ndarray


def _pcg32_step(s: Pcg32State) -> Pcg32State:
    mh, ml = _u32(PCG32_MULT[0]), _u32(PCG32_MULT[1])
    hi, lo = _mul64_lo(s.state_hi, s.state_lo, mh, ml)
    hi, lo = _add64(hi, lo, s.inc_hi, s.inc_lo)
    return Pcg32State(hi, lo, s.inc_hi, s.inc_lo)


def _pcg32_output(state_hi: jnp.ndarray, state_lo: jnp.ndarray) -> jnp.ndarray:
    """XSH-RR output function on the pre-step state (pcg32.h nextUInt)."""
    # x = state ^ (state >> 18), keep 64 bits
    x_hi = state_hi ^ (state_hi >> _u32(18))
    x_lo = state_lo ^ ((state_hi << _u32(14)) | (state_lo >> _u32(18)))
    # xorshifted = uint32(x >> 27)
    xorshifted = (x_hi << _u32(5)) | (x_lo >> _u32(27))
    rot = state_hi >> _u32(27)  # state >> 59
    nrot = (_u32(0) - rot) & _u32(31)
    return (xorshifted >> rot) | (xorshifted << nrot)


def pcg32_seed(initstate_hi, initstate_lo, initseq_hi, initseq_lo) -> Pcg32State:
    """pcg32::seed (pcg32.h): state=0; inc=(seq<<1)|1; step; state+=init; step."""
    ish, isl = _u32(initstate_hi), _u32(initstate_lo)
    qh, ql = _u32(initseq_hi), _u32(initseq_lo)
    inc_hi = (qh << _u32(1)) | (ql >> _u32(31))
    inc_lo = (ql << _u32(1)) | _u32(1)
    s = Pcg32State(
        jnp.zeros_like(inc_hi), jnp.zeros_like(inc_lo), inc_hi, inc_lo
    )
    s = _pcg32_step(s)
    hi, lo = _add64(s.state_hi, s.state_lo, ish, isl)
    s = Pcg32State(hi, lo, s.inc_hi, s.inc_lo)
    return _pcg32_step(s)


def pcg32_next_uint(s: Pcg32State) -> tuple[Pcg32State, jnp.ndarray]:
    """Advance and emit 32 random bits (pcg32.h nextUInt: output(old), step)."""
    out = _pcg32_output(s.state_hi, s.state_lo)
    return _pcg32_step(s), out


def uint32_to_float01(bits: jnp.ndarray) -> jnp.ndarray:
    """[0,1) float from 32 bits, exactly pcg32::nextFloat's bit trick."""
    f = ((bits >> _u32(9)) | _u32(0x3F800000)).view(jnp.float32)
    return f - 1.0


def pcg32_next_float(s: Pcg32State) -> tuple[Pcg32State, jnp.ndarray]:
    s, bits = pcg32_next_uint(s)
    return s, uint32_to_float01(bits)


def pcg32_next_2d(s: Pcg32State) -> tuple[Pcg32State, jnp.ndarray]:
    s, u1 = pcg32_next_float(s)
    s, u2 = pcg32_next_float(s)
    return s, jnp.stack([u1, u2], axis=-1)


# ---------------------------------------------------------------------------
# tea / lcg (reference GPU path, cuda/sutil/random.h)
# ---------------------------------------------------------------------------


def tea(val0: jnp.ndarray, val1: jnp.ndarray, rounds: int = 4) -> jnp.ndarray:
    """TEA hash, matches `tea<N>(val0, val1)` (cuda/sutil/random.h:34-47)."""
    v0 = _u32(val0)
    v1 = _u32(val1)
    s0 = _u32(0)
    for _ in range(rounds):
        s0 = s0 + _u32(0x9E3779B9)
        v0 = v0 + (((v1 << _u32(4)) + _u32(0xA341316C)) ^ (v1 + s0) ^ ((v1 >> _u32(5)) + _u32(0xC8013EA4)))
        v1 = v1 + (((v0 << _u32(4)) + _u32(0xAD90777D)) ^ (v0 + s0) ^ ((v0 >> _u32(5)) + _u32(0x7E95761E)))
    return v0


def lcg_step(state: jnp.ndarray) -> jnp.ndarray:
    """LCG from cuda/sutil/random.h:50-56 (returns new state; bits = state & 0xFFFFFF)."""
    return _u32(state) * _u32(1664525) + _u32(1013904223)


def lcg_next_float(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """`rnd(seed)` (cuda/sutil/random.h:64-67): 24-bit mantissa / 2^24."""
    state = lcg_step(state)
    u = (state & _u32(0x00FFFFFF)).astype(jnp.float32) / jnp.float32(1 << 24)
    return state, u
