"""Device ops: classification, quote-parity scan, bitmask packing,
offset compaction, and the fused stage-1 scans."""
