"""The stage split and the pipelined decoder."""
