"""CPU tests of the benchmark (and, marked ``gpu``, its checks on the card)."""
