"""The megakernel task ledger (counterpart of
triton_distributed_tpu/tools/mk_ledger.py): per-task times of a compiled
program. It needs per-task device timing of the CUDA megakernel, which
comes with ROADMAP.md Queue A, slice 7."""

from __future__ import annotations

from ..megakernel.builder import later_slice


def main(argv=None):
    raise later_slice("tools/mk_ledger.py", "7", " (tools and verification)")


if __name__ == "__main__":
    main()
