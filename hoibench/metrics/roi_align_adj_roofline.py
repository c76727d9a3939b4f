"""The RoIAlign adjoint kernel's share of its roofline in the train step:
the least time its work needs on each traced step's maps and boxes (the
larger of the cotangent, boxes and levels read and the four map gradients
written over HBM bandwidth, and its multiply-adds over the float32 peak),
summed, over the kernel's traced time, summed, in %."""

from hoibench.roofline import adjoint_bound_s, roi_align_share


def read(ctx):
    return roi_align_share(ctx, "roi_align_adjoint_kernel", adjoint_bound_s)
