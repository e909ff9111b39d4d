"""JPEG 2000 Tier-2: packet headers, tag trees, progression iterators."""
