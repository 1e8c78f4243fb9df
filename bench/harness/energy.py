"""The board's own energy counter, read through NVML with ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the board has
used since the driver loaded. The benchmark reads it at both ends of the
measured window; nothing of the program reads it. Where the library or the
counter cannot be read, ``BoardEnergy.open`` returns ``None`` and the metrics
that need it are left out of the result."""

from __future__ import annotations

import ctypes
import sys


class BoardEnergy:
    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle

    @classmethod
    def open(cls, device) -> "BoardEnergy | None":
        """The counter of the board that holds the CUDA ``device``, found by
        its PCI bus id; ``None`` (with the reason on stderr) if unreadable."""
        import torch

        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as exc:
            print(f"energy: NVML not loaded ({exc})", file=sys.stderr)
            return None
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByPciBusId_v2.argtypes = [ctypes.c_char_p,
                                                          ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetHandleByPciBusId_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.nvmlDeviceGetTotalEnergyConsumption.restype = ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            print("energy: nvmlInit failed", file=sys.stderr)
            return None
        props = torch.cuda.get_device_properties(device)
        bus = f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
        handle = ctypes.c_void_p()
        rc = lib.nvmlDeviceGetHandleByPciBusId_v2(bus.encode(), ctypes.byref(handle))
        if rc != 0:
            print(f"energy: no NVML device at {bus} (error {rc})", file=sys.stderr)
            lib.nvmlShutdown()
            return None
        board = cls(lib, handle)
        try:
            board.read_j()
        except OSError as exc:
            print(f"energy: {exc}", file=sys.stderr)
            board.close()
            return None
        return board

    def read_j(self) -> float:
        mj = ctypes.c_ulonglong()
        rc = self._lib.nvmlDeviceGetTotalEnergyConsumption(self._handle, ctypes.byref(mj))
        if rc != 0:
            raise OSError(f"nvmlDeviceGetTotalEnergyConsumption failed (error {rc})")
        return mj.value / 1e3

    def wait_tick(self) -> float:
        """Spin until the counter moves; its new reading."""
        last = self.read_j()
        while True:
            v = self.read_j()
            if v != last:
                return v

    def close(self) -> None:
        if self._lib is not None:
            self._lib.nvmlShutdown()
            self._lib = None
