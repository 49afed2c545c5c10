"""Music theory: chord vocabulary, simplification, key, quantisation."""
