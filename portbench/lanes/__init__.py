"""One module a lane: ``portbench/lanes/<lane>.py`` drives the program's
entry for the traffic files whose ``lane`` names it."""
