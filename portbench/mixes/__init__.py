"""The general code of each kind of traffic mix: a mix's ``kind`` names its module."""
