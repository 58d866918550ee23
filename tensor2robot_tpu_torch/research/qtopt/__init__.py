"""QT-Opt: the Grasping44 critic and its CEM policy."""
