"""ResNet-50 + FPN backbone, graph head and the SCG network."""
