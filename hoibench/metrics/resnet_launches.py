"""Kernel launches the host issued under the program's ``skghoi.resnet50``
span (the ResNet-50 body's forward, shared by the SCG and DETR: convolutions,
frozen BatchNorm's constants and multiply-adds, ReLUs, residual adds) per
traced unit."""

from hoibench.spans import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, ("resnet50",))
