"""The algorithm: signs, flat buffers, votes and the hierarchical step."""
