"""Dictionary dedup on the device (the single-device part of
pfbwtf_tpu/parallel/)."""
