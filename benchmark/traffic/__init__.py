"""Traffic: one general generator per kind of mix (`videos`, `clips`), each
reading the parameters of a mix from `traffic/<mix>.json`."""
