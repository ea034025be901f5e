"""The port's serving path: int8 weight quantization (``quant``), the page
pool (``kvpool``) and the continuous-batching engines (``batcher``): the
paged one and the dense slot engine."""

from .batcher import BatchingDecoder, DecoderClosed, PagedBatchingDecoder
from .kvpool import KVPool, PageAllocError, PageLease, PrefixTrie
from .quant import QuantizedTensor, dequantize_tree, quantize_tree

__all__ = ["BatchingDecoder", "PagedBatchingDecoder", "DecoderClosed", "KVPool", "PageLease",
           "PrefixTrie", "PageAllocError", "QuantizedTensor", "quantize_tree",
           "dequantize_tree"]
