"""The operation and byte counts against numbers worked by hand from the
layer shapes."""

from cmbench import counts


def test_unet_layer_lengths_by_hand():
    # 900 -> pool 449 -> conv k32 d2 387 -> pool 193 -> conv k32 162
    # -> pool 80 -> conv k16 65 -> pool 32 -> conv k16 17
    assert counts.unet_layer_lengths(900) == ([387, 162, 65, 17],
                                              [17, 65, 162, 387])


def test_unet_flops_by_hand():
    by_hand = 2 * (387 * 16 * 1 * 32 + 162 * 16 * 16 * 32 + 65 * 32 * 16 * 16
                   + 17 * 32 * 32 * 16                      # down blocks
                   + 17 * 32 * 16 * 16 + 65 * 48 * 16 * 16  # up blocks
                   + 162 * 32 * 16 * 32 + 387 * 32 * 4 * 32
                   + 900 * 1 * 4 * 256)                     # head
    assert counts.unet_flops(900) == by_hand == 16_870_400


def test_sweep_bytes_match_the_kernel_table_bound():
    # PERF.md's B1 bound: 0.0716 ms at 3.35 TB/s for N=1000, K=20000, P=3
    b = counts.sweep_bytes(1000, 20000, 3)
    assert b == 4 * (3 * 1000 * 20000 + 2 * 20000 + 4 * 1000 + 3000)
    assert round(counts.sweep_bound_s(1000, 20000, 3) * 1e3, 4) == 0.0717


def test_map_flops():
    gram = 2 * 1000 ** 2 * 20000
    it = counts.caviar_iteration_flops(1000, 20000)
    assert gram < it < 1.05 * gram
    assert counts.map_flops(1000, 20000, 900, 50, demix=False) == 50 * it
    assert (counts.map_flops(1000, 20000, 900, 50)
            == 50 * it + 20000 * 16_870_400)
