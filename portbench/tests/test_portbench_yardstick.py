"""The yardstick's arithmetic and the card line without a card."""

import pytest

from portbench import yardstick


def test_gram_apply_bytes_count_b_as_coo_and_each_operand_once():
    # B^T X: 12 bytes an entry of B, X (vocab x w) read and the output
    # (docs x w) written in float32; B Y the same again
    assert yardstick.gram_apply_bytes(10, 3, 4, 2) == 2 * (120 + 4 * 7 * 2)
    nyt = yardstick.gram_apply_bytes(69_679_427, 102_660, 300_000, 128)
    assert nyt == 2 * (12 * 69_679_427 + 4 * 402_660 * 128)


def test_gram_apply_seconds_at_hbm_bandwidth():
    b = yardstick.gram_apply_bytes(1000, 50, 60, 8)
    assert yardstick.gram_apply_seconds(1000, 50, 60, 8, 13) == \
        pytest.approx(13 * b / 3.35e12)
    assert yardstick.HBM_BYTES_PER_S == 3.35e12


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(yardstick.shutil, "which", lambda name: None)
    assert yardstick.card_info() == {"name": "", "power_limit": ""}
    assert yardstick.card_line() == "card: unknown, power limit unknown"
