"""The flat request's work counts against a reckoning by hand."""
import pytest

from bench import roofline


def test_flat_work_at_the_cell_shape():
    got = roofline.flat_work(256, 1_000_000, 128, 10)
    # corpus 1e6 x 128 x 4 = 512,000,000; endpoints 1e6 x 2 x 4 =
    # 8,000,000; queries 256 x 128 x 4 = 131,072 and their endpoints
    # 256 x 2 x 4 = 2,048; ids and distances 256 x 10 x 8 = 20,480
    assert got["bytes"] == 512_000_000 + 8_000_000 + 131_072 + 2_048 + 20_480
    # 2 Q N d = 2 x 256 x 1e6 x 128
    assert got["flops"] == 65_536_000_000


def test_flat_bound_is_the_byte_time_on_an_h100():
    bound = roofline.flat_bound_s("NVIDIA H100 80GB HBM3", 256, 1_000_000,
                                  128, 10)
    # 520,153,600 B / 3.35e12 B/s = 155.27 us > 65.536e9 / 495e12 = 132.4 us
    assert bound == pytest.approx(520_153_600 / 3.35e12)
    assert roofline.flat_bound_s("some other card", 256, 10, 8, 1) is None
