"""Traffic: each mix is a data file ``<mix>.json`` here, and its
``generator`` names a module of this folder that turns the mix, the corpus
and the seed into requests."""
