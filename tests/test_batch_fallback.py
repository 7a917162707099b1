"""`--batch` table placement: the table goes to the device exactly when
JAX's backend is the GPU, the device path gives the host rows, and a
device error propagates instead of falling back to the host."""

import io
from argparse import Namespace
from contextlib import redirect_stdout

import pytest

from km_tpu.io.fasta import read_target
from km_tpu.models.sequence import TargetSeq
from km_tpu.models.table import CountTable
from km_tpu.ops.device_table import DeviceCountTable
from km_tpu.tools import batchmode

from helpers import REFDATA

TARGET = f"{REFDATA}/catalog/GRCh38/NPM1_4ins_exons_10-11utr.fa"
JF = f"{REFDATA}/jf/02H025_NPM1.jf"

ARGS = Namespace(ratio=0.05, count=5, steps=500, branchs=10, nodes=10000,
                 graphical=False)


def _load():
    table = CountTable.from_jf(JF)
    seqs, _ = read_target(TARGET)
    return [TargetSeq("".join(seqs), "NPM1", table.k)], table


def _expected_rows(targets, table):
    from km_tpu.models.batch import run_catalog

    return [str(r) for rows in run_catalog(targets, table, walk="host")
            for r in rows]


def _emit(targets, table):
    out = io.StringIO()
    with redirect_stdout(out):
        batchmode.emit_batched(targets, table, ARGS)
    return [line for line in out.getvalue().splitlines() if line]


def test_healthy_probe_uses_device_path(monkeypatch):
    """With a GPU backend the table is promoted to the device and the
    device pipeline (here on the CPU backend) produces the exact rows."""
    monkeypatch.setattr(batchmode, "_device_backend", lambda: True)

    targets, table = _load()
    assert isinstance(batchmode.prepare_table(table), DeviceCountTable)
    rows = _emit(targets, table)
    assert rows == _expected_rows(targets, table)


def test_cpu_backend_skips_probe_message(monkeypatch, capsys):
    """Without a GPU backend the host table runs the host batch path,
    silently."""
    monkeypatch.setattr(batchmode, "_device_backend", lambda: False)

    targets, table = _load()
    assert batchmode.prepare_table(table) is table
    rows = _emit(targets, table)
    assert rows == _expected_rows(targets, table)
    assert capsys.readouterr().err == ""


def test_prepare_table_lets_device_error_through(monkeypatch):
    """A failing device promotion raises; it never turns into host
    rows."""
    monkeypatch.setattr(batchmode, "_device_backend", lambda: True)

    def broken(_table):
        raise RuntimeError("device allocation failed")

    monkeypatch.setattr(DeviceCountTable, "from_host", broken)
    targets, table = _load()
    with pytest.raises(RuntimeError, match="device allocation failed"):
        _emit(targets, table)


def test_device_backend_is_gpu_only():
    """The CPU backend the tests run on is not a device backend."""
    assert batchmode._device_backend() is False
