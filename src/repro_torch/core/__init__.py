"""F-Quantization core: row-wise quantization, tiers, QAT store and the
tier-partitioned packed serving store."""
