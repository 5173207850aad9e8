"""The reference's products, in its own precision or the control's.

'f64' multiplies in float64. 'tf32' multiplies float32 operands rounded
to TF32 (10 explicit mantissa bits, round to nearest even), summing in
float32: what one pass of a TF32 tensor core computes, emulated the same
way on any device so that the control reads alike on the CPU and the
card.
"""

import torch


def tf32_round(a):
    """float32 `a` rounded to the nearest TF32 value (ties to even)."""
    bits = a.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0x0FFF + keep) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a, b, mode):
    if mode == 'f64':
        return a.to(torch.float64) @ b.to(torch.float64)
    if mode != 'tf32':
        raise ValueError(f'unknown mode {mode!r}')
    return tf32_round(a.to(torch.float32)) @ tf32_round(b.to(torch.float32))
