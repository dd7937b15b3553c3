"""Inference engine: prefill, then a Python loop of decode steps
(counterpart of triton_distributed_tpu/models/engine.py).

The JAX engine compiles prefill + a `lax.scan` of decode steps into one
program; eager PyTorch runs the same steps one by one. Prompt lengths
are bucketed exactly as there (`prompt_bucket`): the prompt is padded to
the bucket and the real length is threaded through `prefill(true_len=)`,
which the paged serving engine of a later slice relies on.

The model may run n tensor-parallel ranks (`DenseLLM(num_ranks=n)`):
`serve`, `start` and `step` are unchanged for the caller, tokens come back
as (B,), and each of them checks the fault words of the communication
kernels (shmem.check_faults) before it hands tokens back, so no token
computed from a faulted kernel's unwritten output leaves the engine.
"""

from __future__ import annotations

import torch

from ..shmem import check_faults
from .kv_cache import KVCache

_BUCKET_FLOOR = 8


def pow2_bucket(n: int, floor: int, cap: int) -> int:
    """The smallest power of two >= n (at least `floor`), clamped to
    `cap` — a clamped bucket is not a power of two but is the only size
    that still fits."""
    b = max(floor, 1 << max(n - 1, 0).bit_length())
    return max(n, min(b, cap))


def prompt_bucket(s: int, cap: int) -> int:
    """Power-of-2 prompt-length bucket (floor 8), clamped to `cap`
    (= max_len - gen_len)."""
    return pow2_bucket(s, _BUCKET_FLOOR, cap)


class Engine:

    def __init__(self, model, params, *, max_len: int = 2048):
        self.model = model
        self.params = params
        self.max_len = max_len

    def _pad_to_bucket(self, ids, cap: int):
        S = ids.shape[1]
        s_b = prompt_bucket(S, cap)
        if s_b != S:
            ids = torch.nn.functional.pad(ids, (0, s_b - S))
        return ids, S

    def _ids(self, input_ids):
        return torch.as_tensor(input_ids, dtype=torch.int32,
                               device=self.model.device)

    def serve(self, input_ids, gen_len: int, *, temperature: float = 0.0,
              top_k: int = 50, seed: int = 0):
        """input_ids: (B, S) ints (array or tensor). Returns (B, gen_len)
        int32 numpy array of generated tokens (prompt not included).
        temperature 0 =
        greedy; > 0 = top-k temperature sampling for the decode steps,
        drawing from a torch.Generator seeded with `seed` (the first
        token comes from prefill and is greedy, as in the JAX engine)."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        if gen_len < 1:
            raise ValueError(f"gen_len must be >= 1, got {gen_len}")
        if S + gen_len > self.max_len:
            raise ValueError(f"{S}+{gen_len} exceeds max_len={self.max_len}")
        ids, true_len = self._pad_to_bucket(ids, self.max_len - gen_len)
        cache = self.model.new_kv_cache(B, self.max_len)
        tok, cache = self.model.prefill(self.params, ids, cache, true_len)
        sampling = temperature > 0.0
        gen = None
        if sampling:
            gen = torch.Generator(device=self.model.device)
            gen.manual_seed(seed)
        toks = [tok]
        for _ in range(gen_len - 1):
            tok, cache = self.model.decode_step(
                self.params, tok, cache, gen, sampling=sampling,
                temperature=max(temperature, 1e-6), top_k=int(top_k))
            toks.append(tok)
        return self._checked(torch.stack(toks, dim=1).cpu().numpy())

    def _checked(self, out):
        """`out`, once no tensor-parallel kernel has recorded a fault (a
        fault raises here; synchronises at n > 1 ranks)."""
        if getattr(self.model, "n", 1) > 1:
            check_faults()
        return out

    # -- stepwise API (token streaming) -----------------------------------
    def start(self, input_ids):
        """Prefill one batch of prompts: (first token (B,), cache)."""
        ids, true_len = self._pad_to_bucket(self._ids(input_ids),
                                            self.max_len)
        cache = self.model.new_kv_cache(ids.shape[0], self.max_len)
        return self._checked(
            self.model.prefill(self.params, ids, cache, true_len))

    def step(self, tok, cache: KVCache, generator=None, *,
             temperature: float = 0.0, top_k: int = 50):
        """One decode step with `serve`'s sampling semantics: temperature
        0 = greedy; > 0 = top-k temperature sampling from `generator`."""
        sampling = temperature > 0.0
        if sampling and generator is None:
            raise ValueError("sampling requires a torch.Generator")
        return self._checked(self.model.decode_step(
            self.params, tok, cache, generator, sampling=sampling,
            temperature=max(temperature, 1e-6), top_k=int(top_k)))
