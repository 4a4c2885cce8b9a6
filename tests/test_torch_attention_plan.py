"""The plain-Python halves of the attention kernels' launches, on the CPU:
which route ``flash_attention`` takes (tensor cores for bf16 with head
dims that are multiples of 16 read 16 bytes at a time, CUDA cores for
the rest) and how many blocks ``decode_attention`` splits a request's
cache over (a function of shapes alone, never of ``lengths``).  The
kernels themselves run only on the card
(``tests/test_torch_attention_kernel.py``)."""
import inspect

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention import kernel as fk

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,Dh,Dv,aligned,want", [
    (BF16, 64, 64, True, "wgmma"),     # the serving shapes
    (BF16, 128, 32, True, "wgmma"),    # Dv != Dh
    (BF16, 16, 256, True, "wgmma"),    # the ends of the range
    (BF16, 256, 16, True, "wgmma"),
    (F32, 64, 64, True, "simt"),       # f32 would round to TF32
    (BF16, 72, 72, True, "simt"),      # not a multiple of 16
    (BF16, 64, 40, True, "simt"),
    (BF16, 8, 8, True, "simt"),
    (BF16, 64, 64, False, "simt"),     # unaligned view
    (BF16, 272, 64, True, "simt"),     # past 256 (the wrapper refuses it)
])
def test_flash_route_of(dtype, Dh, Dv, aligned, want):
    assert fk.route_of(dtype, Dh, Dv, aligned) == want


def test_flash_route_reads_alignment_from_the_tensors():
    """A packed QKV projection's slices are 16-byte aligned views (the
    tensor-core route); a view one element into a buffer is not."""
    qkv = torch.zeros((2, 10, 8, 64), dtype=BF16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert fk.route(q, k, v) == "wgmma"
    assert fk.route(q.float(), k.float(), v.float()) == "simt"
    buf = torch.zeros((2, 10, 6, 65), dtype=BF16)
    q, k, v = buf[:, :, :4, 1:], buf[:, :, 4:5, 1:], buf[:, :, 5:, 1:]
    assert not fk.vec_ok(q, k, v) and fk.route(q, k, v) == "simt"


def test_flash_route_counters_start_at_zero_for_every_route():
    assert set(fk.flash_attention.launches_by_route) == set(fk.ROUTES)
    assert set(fk.ROUTES) == {"wgmma", "simt"}


@pytest.mark.parametrize("B,Hkv,S,want", [
    (8, 2, 512, 8),      # qwen2-0.5b decode: 16 groups -> 128 blocks
    (8, 32, 512, 2),     # zamba2-1.2b decode: 256 groups -> 512 blocks
    (1, 1, 4096, dk.MAX_SPLITS),
    (8, 2, 100, 2),      # no more splits than 64-row tiles
    (1, 1, 1, 1),
    (264, 1, 4096, 1),   # enough groups to fill the card alone
])
def test_decode_plan_splits(B, Hkv, S, want):
    assert dk.plan_splits(B, Hkv, S) == want


@pytest.mark.parametrize("sms", [1, 132, 1000])
def test_decode_plan_splits_bounds(sms):
    for B in (1, 3, 8, 64):
        for Hkv in (1, 2, 8, 32):
            for S in (1, 63, 64, 65, 512, 4096):
                n = dk.plan_splits(B, Hkv, S, sms)
                assert 1 <= n <= min(-(-S // dk.TILE), dk.MAX_SPLITS)


def test_decode_plan_reads_no_lengths():
    """The plan is a function of shapes alone: reading ``lengths`` on
    the host would sync it with the card every decode step."""
    assert list(inspect.signature(dk.plan_splits).parameters) == [
        "B", "Hkv", "S", "sms"]
