"""SYNTHETIC musculoskeletal hand scene at myoHand's widths (see build.py).

A test and smoke fixture that ships with the repository, so the engine,
envs and trainers run without the MyoSuite asset tree. It is never
registered under a Myo task ID and no number taken on it is a Myo number.
"""
import os

NAME = "synth_hand_23dof_39mus"
XML_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        NAME + ".xml")
NPZ_PATH = XML_PATH[:-4] + ".npz"
