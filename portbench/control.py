"""What stands in the program's place to show that the judge fails what
it must: the control and the planted faults.

* :class:`Control`: the plain reference in the program's place, its
  DCT and IDCT in TF32 (``codec.tf32``), the nearest precision below
  the float32 that the configurations state. It has to come out not
  correct.
* :data:`FAULTS`: the program with its output broken where it is
  produced: ``stale`` returns the previous call's answer (a step that
  returns its state unchanged), ``half`` leaves out the second half of
  each answer (the stream's second half of segments, the frame's second
  half of bytes), ``altered`` changes one byte of each stream's scan
  data and one tile of each frame. A run over any of them has to come
  out not correct; ``tests/test_portbench_faults.py`` holds it so.

``python -m portbench.control CELL --seeds N [--seed0 S]`` reads the
judge's numbers of the program, the control and every fault on the
cell's own sizes and load, in one process, and prints them as JSON.
"""
from __future__ import annotations

import torch

from .judge import Deployment
from .program import Program
from .reference.geometry import PIXEL_FORMATS


class Control:
    precision = "tf32"

    def __init__(self, cfg: dict, traffic: dict, device, perf_stats: bool,
                 dep: Deployment):
        self.dep = dep
        self.device = torch.device(device)
        self.to_device = traffic["output"] == "device"

    def encode(self, frame) -> bytes:
        return self.dep.stream(torch.as_tensor(frame).to(self.device),
                               self.precision)

    def decode(self, stream: bytes):
        coeff, quant = self.dep.decode([stream], self.device)[0]
        out = self.dep.output(coeff, quant, self.precision)
        return out if self.to_device else out.cpu().numpy()

    def encode_stats(self) -> dict:
        return {}

    def decode_stats(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class Fault(Program):
    """The program with one fault planted in its answers."""

    kind = ""

    def __init__(self, cfg, traffic, device, perf_stats, dep=None):
        super().__init__(cfg, traffic, device, perf_stats)
        self.cfg = cfg
        self.last = {}

    def encode(self, frame) -> bytes:
        return self.plant("encode", super().encode(frame))

    def decode(self, stream: bytes):
        return self.plant("decode", super().decode(stream))

    def plant(self, what: str, out):
        if self.kind == "stale":
            prev = self.last.get(what)
            self.last[what] = out
            return out if prev is None else prev
        if what == "encode":
            sos = out.rfind(b"\xff\xda")
            if self.kind == "half":
                return out[:sos + (len(out) - sos) // 2] + b"\xff\xd9"
            b = bytearray(out)
            b[sos + (len(out) - sos) // 2] ^= 0x55
            return bytes(b)
        flat = out.reshape(-1)
        n = flat.shape[0]
        if self.kind == "half":
            flat[n // 2:] = 0
            return out
        planar, bpp, _ = PIXEL_FORMATS[self.cfg["output_pixel_format"]]
        row = self.cfg["width"] * (1 if planar else bpp)
        r0 = self.cfg["height"] // 16 * 8
        for r in range(r0, r0 + 8):
            flat[r * row:r * row + 8 * (1 if planar else bpp)] ^= 0x40
        return out


def _fault(kind: str) -> type:
    return type("Fault_" + kind, (Fault,), {"kind": kind})


FAULTS = {k: _fault(k) for k in ("stale", "half", "altered")}


def main(argv=None) -> int:
    import argparse
    import json

    from . import run
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cell")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seed0", type=int, default=2 ** 31 + 7)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", action="store_true",
                   help="also read each planted fault")
    a = p.parse_args(argv)
    run.use_cache_dirs()
    cell = run.load(a.cell)
    kinds = [("program", None), ("control", Control)]
    if a.faults:
        kinds += list(FAULTS.items())
    for name, make in kinds:
        n = a.seeds if name == "program" else a.control_seeds
        for s in range(n):
            res, _ = run.run_cell(cell, a.seed0 + 1000 * s, a.seconds, False,
                                  make_coders=make)
            row = {"coder": name, "seed": a.seed0 + 1000 * s,
                   "correct": res["correct"],
                   **{k: v["value"] for k, v in res["checks"].items()}}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
