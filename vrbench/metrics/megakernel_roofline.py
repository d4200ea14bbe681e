"""megakernel_roofline: the render kernel's share of its work bound, in
percent, on one dispatch of the cell's size (64 spp offline, 4 spp a step)
on the cell's tables (vrbench.roofline.dispatch_share: the frozen bound
from the STATS instantiation's events over the dispatch's CUDA-event
milliseconds). It also reads ``megakernel_roofline.step``, the same
quantity in the cells whose end-to-end metric is a step's latency."""

from vrbench.roofline import dispatch_share


def read(ctx):
    return dispatch_share(ctx)
