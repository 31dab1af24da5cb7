"""One driver per kind of traffic (``train``); a traffic mix is a data
file under ``perfbench/traffic`` that names its kind."""
