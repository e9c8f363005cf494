"""Loops: a traffic mix's ``loop`` names a module of this folder whose
``Loop(engine, traffic, mix)`` warms up, runs the measured window and
picks the answers that the comparison covers."""
