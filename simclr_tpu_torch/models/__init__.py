"""SimCLR model: ResNet encoder, projection head, subset-statistics BN."""
