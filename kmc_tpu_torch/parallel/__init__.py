"""Multi-device counting: the store split into shards, one per device."""
