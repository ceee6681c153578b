"""BTS: a ResNet/ResNeXt/DenseNet encoder and the local planar guidance decoder."""
