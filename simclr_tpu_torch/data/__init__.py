"""Dataset decoding and the device-resident pipeline."""
