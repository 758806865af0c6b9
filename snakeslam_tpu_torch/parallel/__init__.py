"""Multi-device execution: a device mesh driven by one process, the sharded
Hamming matcher and the sharded bundle-adjustment step."""
