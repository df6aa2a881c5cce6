"""MapReduce primitives: lane packing, shuffle keys, lexicographic sort, runs."""
