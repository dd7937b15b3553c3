"""Tools (counterpart of triton_distributed_tpu/tools/): ported with
ROADMAP.md Queue A, slice 7."""
