"""Kernel F2's (the deep march's) share of its roofline in the traced
window: ``roofline.floor_s`` of each launch's wave, as the driver recorded
it, over the launches' device time.  None where F2 never ran or its
driver records no waves."""

from portbench import roofline


def read(ctx):
    return roofline.share_pct(ctx, "deep_warp_march_kernel")
