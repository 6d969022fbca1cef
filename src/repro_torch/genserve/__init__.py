"""Continuous-batching generation server (port of ``repro.genserve``):
a request queue (FIFO or shortest-job-first) feeding at most ``wave``
decode slots, one-shot or chunked admission, the paged KV cache with
radix prefix reuse, speculative decoding, and slot failures and cancels.
``genserve.decoder`` has the device-program table."""
from repro_torch.genserve.adapter import (  # noqa: F401
    generate, wave_stats_from_mask)
from repro_torch.genserve.decoder import GenServeConfig, serve  # noqa: F401
from repro_torch.genserve.pagepool import PagePool, RadixCache  # noqa: F401
from repro_torch.genserve.scheduler import (  # noqa: F401
    Request, RequestQueue, SlotTable)
