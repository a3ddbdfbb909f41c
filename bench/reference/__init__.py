"""reference"""
