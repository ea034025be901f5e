"""The port's serving path: int8 weight quantization (``quant``), the page
pool (``kvpool``) and the paged continuous-batching engine (``batcher``)."""

from .batcher import DecoderClosed, PagedBatchingDecoder
from .kvpool import KVPool, PageAllocError, PageLease, PrefixTrie
from .quant import QuantizedTensor, dequantize_tree, quantize_tree

__all__ = ["PagedBatchingDecoder", "DecoderClosed", "KVPool", "PageLease",
           "PrefixTrie", "PageAllocError", "QuantizedTensor", "quantize_tree",
           "dequantize_tree"]
